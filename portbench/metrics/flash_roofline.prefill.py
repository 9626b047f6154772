"""Flash attention's launches in the traced batches: their summed least time
over their summed device time, in percent."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline_percent(ctx, "flash_attention")
