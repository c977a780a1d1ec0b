"""Device ms a step in engine/train_step, SGD, the scheduler and the
prototype's copy: the stream interval of the program's own ``optimizer``
span (``scan_tpu_torch.utils.profiler``) in the traced slice, over the
calls of its ``step`` span. None where the program records no such span."""


def read(ctx):
    try:
        from scan_tpu_torch.utils.profiler import snapshot
    except ImportError:  # a program without spans of its own
        return None
    spans = snapshot()["spans"]
    root, part = spans.get("step"), spans.get("optimizer")
    if not root or not part or part["device_ms"] is None:
        return None
    return part["device_ms"] / root["calls"]
