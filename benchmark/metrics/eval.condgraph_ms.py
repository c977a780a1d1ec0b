"""Device ms a batch in modeling/condgraph (head_in, act maps, head_out): the operations launched inside
the ``middle_head`` span of the traced slice, over its batches."""

from benchmark.harness.trace import span_seconds


def read(ctx):
    s = span_seconds(ctx.summary, "middle_head")
    return 1e3 * s / ctx.summary["units"] if s > 0 else None
