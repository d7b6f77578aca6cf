"""raster_roofline: the least time a frame's rasterization needs,
as a share of ``raster.kernel_ms``.

The least time is the larger of the bytes term (each visible row's three
clip-space vertices read once, the presented colour and depth planes and
the shadow map written once, over the peak bandwidth) and the operations
term (covered (row, pixel) pairs x ``OPS_PER_PAIR``, over the peak
operation rate), counted by the plain reference's code from the
benchmark's own scene and cameras (``reference/common.py``), whatever
kernel or binning does the work.  Peaks: ``perfbench/peaks.json``."""



def read(ctx):
    peak = ctx["peaks"].get(ctx["device_kind"])
    work = ctx["raster_work"]
    rast = ctx["raster_kernels"]
    us = sum(dur for name, _, dur in ctx["device_events"] if name in rast)
    if peak is None or work is None or not us:
        return None
    least_s = max(work["bytes"] / peak["bytes_per_s"],
                  work["ops"] / peak["ops_per_s"])
    return 100.0 * least_s / (us * 1e-6 / ctx["frames"])
