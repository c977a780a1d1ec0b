"""Device ms a step in modeling/discriminator (CKA, GA, CA), forward: the operations launched inside
the ``discriminator`` span of the traced slice, over its steps."""

from benchmark.harness.trace import span_seconds


def read(ctx):
    s = span_seconds(ctx.summary, "discriminator")
    return 1e3 * s / ctx.summary["units"] if s > 0 else None
