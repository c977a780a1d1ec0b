"""The whole DA step's share of the peak of the cards it runs on, in %: the
model operations of a step (``_counts.da_step_flops`` at the traffic's
``batch``, the global batch on several cards: both domains' forward and
the backward of what trains) over the window's seconds a step and the
peak of the cell's precision times the cards."""

from benchmark.metrics._counts import PEAK_FLOPS, da_step_flops, share


def read(ctx):
    t = ctx.work["traffic"]
    flops = da_step_flops(ctx.cfg, t["batch"], *t["pad"])
    peak = PEAK_FLOPS[ctx.work["precision"]] * ctx.work["chips"]
    return share(flops / peak, ctx.unit_s)
