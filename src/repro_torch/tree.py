"""Nested containers of tensors: the port's stand-in for ``jax.tree``.

A tree is a dict, tuple (named or not) or list of trees, or a leaf (a tensor
or any other object). Leaves are visited in the containers' own order, the
same order by every function here, so ``tree_like(t, tree_leaves(t))``
rebuilds ``t``.
"""

from __future__ import annotations

from functools import lru_cache

import torch


def tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree`` and of the trees in ``rest`` (same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        mapped = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_like(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_stack(trees):
    """Trees of one structure stacked leaf by leaf along a new leading dim."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_index(tree, i):
    """Row ``i`` of every leaf."""
    return tree_map(lambda x: x[i], tree)


def tree_rel_gap(got, want) -> float:
    """Largest |got - want| over the largest |want|, leaf by leaf, the worst
    leaf's (in fp32, on the CPU)."""
    return max(((g.float().cpu() - w.float().cpu()).abs().max()
                / w.float().cpu().abs().max().clamp(min=1e-30)).item()
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


@lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return torch.tensor(x, dtype=dtype).item()


def weak(x: float, like: torch.Tensor) -> float:
    """The Python number ``x`` as JAX uses a weakly typed scalar next to
    ``like``: rounded to ``like``'s dtype first. torch would otherwise apply
    the unrounded value in fp32 (``0.1 * t`` on a bfloat16 ``t``), and the
    product could land one bfloat16 step from the reference's. No device
    work: the rounding happens on the host."""
    return _rounded(float(x), like.dtype)
