"""Device ms a batch in modeling/fcos/postprocess (TEST.MODE mixing, top-k, K1): the operations launched inside
the ``postprocess`` span of the traced slice, over its batches."""

from benchmark.harness.trace import span_seconds


def read(ctx):
    s = span_seconds(ctx.summary, "postprocess")
    return 1e3 * s / ctx.summary["units"] if s > 0 else None
