"""device.idle_share: the share of the unprofiled window in which the
device had nothing to do, 1 - (busy ms per frame of the profiled
stretch x the unprofiled frames a second) / 1000, in percent.  It stands
in for the profiled stretch's own idle share, which the profiler's slower
host inflates."""


def read(ctx):
    if not ctx["device_events"]:
        return None
    busy_ms = ctx["trace"]["busy_us"] * 1e-3 / ctx["frames"]
    return 100.0 * (1.0 - busy_ms * ctx["fps_unprofiled"] / 1000.0)
