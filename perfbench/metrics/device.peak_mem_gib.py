"""device.peak_mem_gib: ``torch.cuda.max_memory_allocated`` over the
window, in GiB."""


def read(ctx):
    peak = ctx["window_peak_bytes"]
    return peak / 2**30 if peak else None
