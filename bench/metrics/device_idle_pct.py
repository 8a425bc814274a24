"""The card's idle share of the traced window: the window's wall time
less the union of its device activities, over the wall time."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (ctx.window_s - ctx.trace.busy_s) / ctx.window_s
