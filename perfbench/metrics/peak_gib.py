"""The allocator's peak over the window (``max_memory_allocated`` after
``reset_peak_memory_stats`` at its start), in GiB: weights, optimizer
state, activations and batches."""


def read(ctx):
    return ctx.peak_allocated / 2 ** 30 if ctx.peak_allocated else None
