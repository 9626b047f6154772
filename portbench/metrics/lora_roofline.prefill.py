"""The fused LoRA matmul's launches in the traced batches: their summed least
time (bytes at HBM's rate or operations at the bf16 peak, from their shapes)
over their summed device time, in percent."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline_percent(ctx, "lora_matmul")
