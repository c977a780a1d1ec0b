"""The device's idle share of the traced slice of batches, in %: 1 - the
union of its operations' intervals over the slice's wall time."""


def read(ctx):
    return 100.0 * (1.0 - ctx.summary["busy_s"] / ctx.window_s)
