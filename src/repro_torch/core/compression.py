"""Uplink gradient/update compression (port of ``repro/core/compression.py``).

The paper charges s_c = 28.1 kbit per client-side upload. Top-k
sparsification with error feedback (memory) and int8 quantisation shrink the
simulated uplink volume; ``compressed_bits`` feeds the delay model so the
resource allocator sees the smaller s_c. Error feedback keeps convergence
(Karimireddy et al. 2019).

The arithmetic is the reference's, operation for operation and in the
input's dtype: ``torch.round`` rounds half to even as ``jnp.round`` does, and
``torch.topk``'s k-th value with the same ``>=`` keeps the same entries, ties
included.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.tree import tree_leaves, tree_map


def topk_mask(x: torch.Tensor, fraction: float) -> torch.Tensor:
    """Keep the top-|fraction| entries by magnitude (per leaf); every entry
    as large as the k-th largest is kept."""
    n = x.numel()
    k = max(1, int(math.ceil(fraction * n)))
    thresh = torch.topk(x.abs().reshape(-1), k).values[-1]
    return (x.abs() >= thresh).to(x.dtype)


def compress_tree(tree, fraction: float, error=None):
    """Top-k + error feedback. Returns (sparse_tree, new_error, bits)."""
    if error is None:
        error = tree_map(torch.zeros_like, tree)
    corrected = tree_map(torch.add, tree, error)
    sparse = tree_map(lambda x: x * topk_mask(x, fraction), corrected)
    new_error = tree_map(torch.sub, corrected, sparse)
    return sparse, new_error, compressed_bits(tree, fraction)


def quantize_int8(x: torch.Tensor):
    """Per-tensor absmax int8: (q, scale), the scale in ``x``'s dtype."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    return q.to(dtype) * scale


def compress_tree_int8(tree):
    """int8 quantise every leaf. Returns (q_tree, bits)."""
    q = tree_map(quantize_int8, tree)
    bits = sum(x.numel() * 8 + 32 for x in tree_leaves(tree))
    return q, bits


def decompress_tree_int8(q_tree):
    """The inverse of ``compress_tree_int8``'s leaves, fp32."""
    if isinstance(q_tree, tuple) and len(q_tree) == 2 and isinstance(q_tree[0], torch.Tensor):
        return dequantize_int8(*q_tree)
    if isinstance(q_tree, dict):
        return {k: decompress_tree_int8(v) for k, v in q_tree.items()}
    return type(q_tree)(decompress_tree_int8(v) for v in q_tree)


def compressed_bits(tree, fraction: float, index_bits: Optional[int] = None,
                    value_bits: int = 32) -> float:
    """Uplink volume of a top-k sparsified tree (values + indices)."""
    total = 0.0
    for x in tree_leaves(tree):
        n = x.numel()
        k = max(1, int(math.ceil(fraction * n)))
        ib = index_bits if index_bits is not None else max(1, math.ceil(math.log2(max(n, 2))))
        total += k * (value_bits + ib)
    return total


def dense_bits(tree, value_bits: int = 32) -> float:
    return float(sum(x.numel() for x in tree_leaves(tree)) * value_bits)
