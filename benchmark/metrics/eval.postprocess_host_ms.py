"""Host ms a batch in modeling/fcos/postprocess (TEST.MODE mixing, top-k,
K1): the program's own ``postprocess`` span
(``scan_tpu_torch.utils.profiler``) of the traced slice, over the calls of
its ``inference`` span. None where the program records no such span."""


def read(ctx):
    try:
        from scan_tpu_torch.utils.profiler import snapshot
    except ImportError:  # a program without spans of its own
        return None
    spans = snapshot()["spans"]
    root, part = spans.get("inference"), spans.get("postprocess")
    if not root or not part or part["host_ms"] is None:
        return None
    return part["host_ms"] / root["calls"]
