"""The share of NMS's candidates that it keeps, in %
(modeling/fcos/postprocess, K1): the program's own counters ``nms.kept``
over ``nms.candidates`` (``scan_tpu_torch.utils.profiler``: the valid
candidates entering K1 in ``select_detections`` and the boxes it keeps)
of the traced slice. None where the program counts neither."""


def read(ctx):
    try:
        from scan_tpu_torch.utils.profiler import snapshot
    except ImportError:  # a program without counters of its own
        return None
    counters = snapshot()["counters"]
    candidates = counters.get("nms.candidates")
    if not candidates or "nms.kept" not in counters:
        return None
    return 100.0 * counters["nms.kept"] / candidates
