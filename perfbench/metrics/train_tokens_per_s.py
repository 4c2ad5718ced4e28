"""Positions trained per second: every position a step holds times the
steps completed in the window, over the time from the window's start to
the end of its last step (each step ends in a synchronize)."""


def read(ctx):
    w = ctx.window
    if not w or not w["steps"]:
        return None
    return w["steps"] * ctx.positions / w["seconds"]
