"""Share of the traced window in which no kernel, copy or fill ran on the
device: 1 - (union of their intervals) / the window."""


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.busy:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
