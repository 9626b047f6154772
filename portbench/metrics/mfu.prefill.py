"""Model FLOPs of the window's prefills (every layer at every prompt token, the
head at the served position) over the window's length at the H100's bf16
dense peak, in percent."""

from portbench.harness import readers


def read(ctx):
    return readers.mfu_percent(ctx)
