"""Prompt tokens of the requests served in the window, over the window's length
(from its start to the end of its last batch)."""

from portbench.harness import readers


def read(ctx):
    return readers.tokens_per_s(ctx)
