"""Device ms a batch in modeling/fcos (the towers and predictions): the operations launched inside
the ``fcos`` span of the traced slice, over its batches."""

from benchmark.harness.trace import span_seconds


def read(ctx):
    s = span_seconds(ctx.summary, "fcos")
    return 1e3 * s / ctx.summary["units"] if s > 0 else None
