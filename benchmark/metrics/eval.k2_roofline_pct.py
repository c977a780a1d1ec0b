"""K2 (the fused VGG16 stage 1, ``stem_bf16_kernel``) against its bound in
bf16, in %: the least time of its launches (``_counts.stem_bound_s`` at the
cell's batch and padded size) over their device time in the traced
slice."""

from benchmark.harness.trace import kernel_seconds
from benchmark.metrics._counts import share, stem_bound_s


def read(ctx):
    secs, n = kernel_seconds(ctx.summary, "stem_bf16_kernel")
    if not n:
        return None
    t = ctx.work["traffic"]
    return share(n * stem_bound_s(t["batch"], *t["pad"], "bfloat16"), secs)
