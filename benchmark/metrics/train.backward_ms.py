"""Device ms a step in engine/train_step: the autograd engine's backward: the operations launched inside
the ``backward`` span of the traced slice, over its steps."""

from benchmark.harness.trace import span_seconds


def read(ctx):
    s = span_seconds(ctx.summary, "backward")
    return 1e3 * s / ctx.summary["units"] if s > 0 else None
