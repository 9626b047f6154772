"""Share of the measured window in which no operation ran on the card: one
minus the traced batches' device busy time per batch over the window's mean
batch time, in percent."""

from portbench.harness import readers


def read(ctx):
    return readers.idle_percent(ctx)
