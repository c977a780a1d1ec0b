"""Device ms a batch in modeling/detector, ``_prep_images`` (uint8 to
normalised float32): the stream interval of the program's own ``prep`` span
(``scan_tpu_torch.utils.profiler``) in the traced slice, over the calls of
its ``inference`` span. None where the program records no such span."""


def read(ctx):
    try:
        from scan_tpu_torch.utils.profiler import snapshot
    except ImportError:  # a program without spans of its own
        return None
    spans = snapshot()["spans"]
    root, part = spans.get("inference"), spans.get("prep")
    if not root or not part or part["device_ms"] is None:
        return None
    return part["device_ms"] / root["calls"]
