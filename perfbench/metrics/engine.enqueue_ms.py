"""engine.enqueue_ms: the host's mean milliseconds inside
``Renderer.render`` per frame, by the harness's clock around the call,
over the unprofiled window."""


def read(ctx):
    ms = ctx["enqueue_ms"]
    return sum(ms) / len(ms) if ms else None
