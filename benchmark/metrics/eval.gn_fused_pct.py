"""The share of the towers' GroupNorm blocks that took the fused conv-bias +
GroupNorm + ReLU kernel, in % (modeling/fcos: the FCOS head's towers and the
condgraph's head_in): the program's own counters ``gn.fused`` over
``gn.calls`` (``scan_tpu_torch.utils.profiler``, counted in
``ConvTower.forward``) of the traced slice. None where the program counts
no GroupNorm block."""


def read(ctx):
    try:
        from scan_tpu_torch.utils.profiler import snapshot
    except ImportError:  # a program without counters of its own
        return None
    counters = snapshot()["counters"]
    calls = counters.get("gn.calls")
    if not calls:
        return None
    return 100.0 * counters.get("gn.fused", 0) / calls
