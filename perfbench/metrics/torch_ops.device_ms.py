"""torch_ops.device_ms: device milliseconds per frame of every device
operation that is not one of the port's own kernels (PyTorch's kernels,
copies and memsets: geometry, prepares, the passes), summed over the
profiled stretch."""


def read(ctx):
    own = ctx["port_kernels"]
    us = [dur for name, _, dur in ctx["device_events"] if name not in own]
    if not ctx["device_events"]:
        return None
    return sum(us) * 1e-3 / ctx["frames"]
