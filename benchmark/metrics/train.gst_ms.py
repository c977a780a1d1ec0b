"""Device ms a step in modeling/condgraph, GST's node sampling: the stream
interval of the program's own ``gst_sample`` span
(``scan_tpu_torch.utils.profiler``, around ``sample_target_nodes``) in the
traced slice, over the calls of its ``step`` span. None where the program
records no such span."""


def read(ctx):
    try:
        from scan_tpu_torch.utils.profiler import snapshot
    except ImportError:  # a program without spans of its own
        return None
    spans = snapshot()["spans"]
    root, part = spans.get("step"), spans.get("gst_sample")
    if not root or not part or part["device_ms"] is None:
        return None
    return part["device_ms"] / root["calls"]
