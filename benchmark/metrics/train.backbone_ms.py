"""Device ms a step in modeling/backbone, both domains' forward: the operations launched inside
the ``backbone`` span of the traced slice, over its steps."""

from benchmark.harness.trace import span_seconds


def read(ctx):
    s = span_seconds(ctx.summary, "backbone")
    return 1e3 * s / ctx.summary["units"] if s > 0 else None
