"""Share of the traced window in which no operation ran on the device
(the union of the device events' intervals, from the profiler)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
