"""The device's idle share of the traced slice of DA steps, in %: 1 - the
union of its operations' intervals over the slice's wall time (averaged
over the cards of a run on several)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.summary["busy_s"] / ctx.window_s)
