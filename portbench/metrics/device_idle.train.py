"""Share of the measured window in which no operation ran on the card: one
minus the traced round's device busy time over the window's mean round time,
in percent."""

from portbench.harness import readers


def read(ctx):
    return readers.idle_percent(ctx)
