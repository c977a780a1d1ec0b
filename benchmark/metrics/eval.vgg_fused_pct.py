"""The share of the VGG body's fp convs after its stem that took the bias +
ReLU (+ 2x2 max-pool) kernel, in % (modeling/backbone): the program's own
counters ``vgg.fused`` over ``vgg.convs`` (``scan_tpu_torch.utils.profiler``,
counted in ``VGG16.forward``) of the traced slice. None where the program
counts no VGG conv."""


def read(ctx):
    try:
        from scan_tpu_torch.utils.profiler import snapshot
    except ImportError:  # a program without counters of its own
        return None
    counters = snapshot()["counters"]
    convs = counters.get("vgg.convs")
    if not convs:
        return None
    return 100.0 * counters.get("vgg.fused", 0) / convs
