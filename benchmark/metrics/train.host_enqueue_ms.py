"""Host ms a step in engine/train_step: the program's own ``step`` span
(``scan_tpu_torch.utils.profiler``) of the traced slice, over its calls:
the host's time inside ``train_step``, its waits for the card included.
None where the program records no such span."""


def read(ctx):
    try:
        from scan_tpu_torch.utils.profiler import snapshot
    except ImportError:  # a program without spans of its own
        return None
    spans = snapshot()["spans"]
    root, part = spans.get("step"), spans.get("step")
    if not root or not part or part["host_ms"] is None:
        return None
    return part["host_ms"] / root["calls"]
