"""Device ms a step in NCCL's all-reduce kernels (engine/dp's one fused
all-reduce of every gradient and metric), averaged over the ranks."""


def read(ctx):
    s = ctx.summary.get("allreduce_s")
    return 1e3 * s / ctx.summary["units"] if s else None
