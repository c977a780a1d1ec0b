"""Host ms a batch in modeling/detector: the program's own ``inference``
span (``scan_tpu_torch.utils.profiler``, around ``forward_inference``) of
the traced slice, over its calls: the host's time to enqueue a batch's
forward, its waits for the card included. None where the program records
no such span."""


def read(ctx):
    try:
        from scan_tpu_torch.utils.profiler import snapshot
    except ImportError:  # a program without spans of its own
        return None
    spans = snapshot()["spans"]
    root, part = spans.get("inference"), spans.get("inference")
    if not root or not part or part["host_ms"] is None:
        return None
    return part["host_ms"] / root["calls"]
