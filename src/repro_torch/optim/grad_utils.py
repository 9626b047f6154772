"""Gradient utilities: global-norm clipping, accumulation (port of
``repro/optim/grad_utils.py``)."""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (leaves summed in
    order, each leaf's own sum first)."""
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(sum(sq) if sq else torch.zeros(()))


def clip_by_global_norm(tree, max_norm: float):
    """``tree`` scaled by min(1, max_norm / ||tree||) in fp32, each leaf cast
    back to its dtype; and the norm."""
    gn = global_norm(tree)
    # a true fp32 division, as jnp divides: torch's ``float / tensor`` is
    # ``tensor.reciprocal() * float``, two roundings
    scale = torch.clamp(torch.full_like(gn, max_norm) / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), gn


def accumulate(microbatch_grads):
    """Mean of a list of grad trees (gradient accumulation)."""
    n = len(microbatch_grads)
    out = microbatch_grads[0]
    for g in microbatch_grads[1:]:
        out = tree_map(torch.add, out, g)
    return tree_map(lambda x: x / n, out)
