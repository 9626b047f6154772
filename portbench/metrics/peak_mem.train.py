"""The allocator's peak over the measured window, in GiB."""

from portbench.harness import readers


def read(ctx):
    return readers.peak_gib(ctx)
