"""The caching allocator's reserved peak over the window
(``max_memory_reserved``), in GiB: what the process holds of the card."""


def read(ctx):
    return ctx.peak_reserved / 2 ** 30 if ctx.peak_reserved else None
