"""engine.ops_per_frame: device operations (kernels, copies, memsets) per
frame of the profiled stretch."""


def read(ctx):
    if not ctx["device_events"]:
        return None
    return len(ctx["device_events"]) / ctx["frames"]
