"""The whole evaluation forward's share of the card's peak, in %: the
model operations of a batch (``_counts.eval_flops``: every conv, linear
and matmul at the padded size) over the untraced window's seconds a batch
and the peak of the cell's precision."""

from benchmark.metrics._counts import PEAK_FLOPS, eval_flops, share


def read(ctx):
    t = ctx.work["traffic"]
    flops = eval_flops(ctx.cfg, t["batch"], *t["pad"])
    return share(flops / PEAK_FLOPS[ctx.work["precision"]], ctx.unit_s)
