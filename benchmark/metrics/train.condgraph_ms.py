"""Device ms a step in modeling/condgraph with GST's node sampling, forward: the operations launched inside
the ``middle_head`` span of the traced slice, over its steps."""

from benchmark.harness.trace import span_seconds


def read(ctx):
    s = span_seconds(ctx.summary, "middle_head")
    return 1e3 * s / ctx.summary["units"] if s > 0 else None
