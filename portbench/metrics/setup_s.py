"""Seconds from the process's start until the measured window opens: imports,
the card's start, loading the built kernels (building them on a checkout's
first run), the weights drawn on the card, and the warm-up."""

def read(ctx):
    return ctx.setup_s
