"""Seconds from the process's start to the window's: imports, the kernel
library (built there in a checkout's first run), the weights and batches,
the program's state and the steps before the window."""


def read(ctx):
    return ctx.setup_s
