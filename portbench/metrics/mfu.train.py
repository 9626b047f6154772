"""Model FLOPs of the window's rounds (LoRA fine-tuning's forward and backward,
base frozen, no recomputation, no merge) over the window's length at the
H100's bf16 dense peak, in percent."""

from portbench.harness import readers


def read(ctx):
    return readers.mfu_percent(ctx)
