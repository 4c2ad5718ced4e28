"""The whole step's share of the card's dense bf16 peak: the model's
FLOPs a step (counted from the configuration and the traffic, forward
and backward, without recompute) times the window's steps, over the
window's time."""

from perfbench.harness import peaks


def read(ctx):
    w = ctx.window
    if not w or not w["steps"]:
        return None
    return 100.0 * ctx.work["model_flops"] * w["steps"] / w["seconds"] \
        / peaks.BF16_FLOPS
