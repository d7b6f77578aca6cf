"""raster.kernel_ms: device milliseconds per frame of the port's raster
kernels (the ``__global__`` functions of ``csrc/raster_*.cu`` and the
package's Triton kernels, by name), summed over the profiled stretch."""


def read(ctx):
    rast = ctx["raster_kernels"]
    us = [dur for name, _, dur in ctx["device_events"] if name in rast]
    if not us:
        return None
    return sum(us) * 1e-3 / ctx["frames"]
