"""Tokens of every split pass of the rounds finished in the window, over the
window's length (from its start to the end of its last round)."""

from portbench.harness import readers


def read(ctx):
    return readers.tokens_per_s(ctx)
