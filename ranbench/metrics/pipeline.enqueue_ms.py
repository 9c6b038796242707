"""pipeline.enqueue_ms: host ms of one ``submit_scan`` (payload copy, noise
draw, graph launch), the mean over the window's dispatches; from the
benchmark's span, with no synchronise inside it."""


def read(cell, out):
    return out.spans.mean_ms("ranbench.enqueue")
