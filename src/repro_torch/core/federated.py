"""Federated aggregation, the paper's fed-server role (port of
``repro/core/federated.py``).

Algorithm 1: Δw_c^(n+1) = Δw_c^(n) + (1/K)·Σ_k h_c,k^(n); the main server
applies the same update to its server-side adapters (Algorithm 2, last
line). Updates arrive as trees whose leaves are stacked (K, ...) over the
clients; every aggregator reduces that axis, in fp32, and casts back.

Fault tolerance: every aggregator takes a (K,) 0/1 survivor ``mask``, so a
round tolerates dropped or straggling clients (``deadline_mask``). The
two-tier ``hier_aggregate`` comes with the topology slice
(``net/topology.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


def _bcast(v, x):
    """(K,) weights shaped to broadcast against a (K, ...) leaf."""
    return v.reshape((v.shape[0],) + (1,) * (x.ndim - 1))


def fedavg(stacked, weights: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None):
    """Weighted average over the leading client axis of every leaf.

    weights: (K,) e.g. D_k (paper: weighted by data size); mask: (K,) 0/1
    survivors."""
    leaves = tree_leaves(stacked)
    if not leaves:
        return stacked
    K = leaves[0].shape[0]
    w = (torch.ones(K, dtype=torch.float32, device=leaves[0].device) if weights is None
         else weights.float())
    if mask is not None:
        w = w * mask.float()
    wn = w / torch.clamp(torch.sum(w), min=1e-12)
    return tree_map(lambda x: torch.sum(x.float() * _bcast(wn, x), dim=0).to(x.dtype), stacked)


def staleness_discount(staleness, beta: float = 0.5) -> np.ndarray:
    """Host-side staleness discount 1/(1+s)^β (the async schedule's
    per-arrival weight scale, multiplied onto D_k before the round fn)."""
    return (1.0 + np.asarray(staleness, float)) ** (-float(beta))


def staleness_weighted(stacked, weights: Optional[torch.Tensor] = None,
                       mask: Optional[torch.Tensor] = None,
                       staleness: Optional[torch.Tensor] = None, beta: float = 0.5):
    """Staleness-aware FedAvg: w_k ∝ D_k / (1 + staleness_k)^β (FedAsync /
    FedBuff). Masked-out clients contribute nothing whatever their staleness;
    ``staleness=None`` is plain (weighted) fedavg, which is how the registered
    ``"staleness"`` aggregator runs when the schedule folds the discount into
    ``weights`` (``staleness_discount``)."""
    leaves = tree_leaves(stacked)
    if not leaves or staleness is None:
        return fedavg(stacked, weights=weights, mask=mask)
    K = leaves[0].shape[0]
    w = (torch.ones(K, dtype=torch.float32, device=leaves[0].device) if weights is None
         else weights.float())
    w = w * (1.0 + torch.as_tensor(staleness, dtype=torch.float32, device=w.device)) ** (-beta)
    return fedavg(stacked, weights=w, mask=mask)


def _median0(x):
    """numpy's median over axis 0 (the mean of the two middle values)."""
    xs = torch.sort(x, dim=0).values
    K = x.shape[0]
    return (xs[(K - 1) // 2] + xs[K // 2]) * 0.5


def coordinate_median(stacked, weights: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None):
    """Coordinate-wise median over the client axis (robust aggregation).

    Masked-out clients are left out of every coordinate's order statistic;
    with no survivor the result is 0. ``weights`` is accepted for the
    aggregator signature and ignored (an unweighted order statistic)."""
    leaves = tree_leaves(stacked)
    if not leaves:
        return stacked

    def one(x):
        xf = x.float()
        if mask is None:
            return _median0(xf).to(x.dtype)
        keep = _bcast(mask.float(), xf) > 0
        # masked rows sort last; the median of the first n = survivors rows
        xs = torch.sort(torch.where(keep, xf, torch.inf), dim=0).values
        n = torch.sum(mask.float() > 0)
        lo = torch.clamp((n - 1) // 2, min=0).reshape(1)
        hi = torch.clamp(n // 2, max=xf.shape[0] - 1).reshape(1)
        med = (xs.index_select(0, lo)[0] + xs.index_select(0, hi)[0]) * 0.5
        return torch.where(n > 0, med, torch.zeros_like(med)).to(x.dtype)

    return tree_map(one, stacked)


def trimmed_mean(stacked, weights: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None, trim: float = 0.2):
    """Coordinate-wise β-trimmed mean: drop the ⌈β·K⌉ largest and smallest
    values per coordinate (at most (K-1)//2 each), average the rest.

    Masked-out clients are first replaced, per coordinate, by the survivor
    mean, so they sit in neither tail. ``weights`` is ignored."""
    leaves = tree_leaves(stacked)
    if not leaves:
        return stacked
    K = leaves[0].shape[0]
    k_trim = min(int(np.ceil(trim * K)), (K - 1) // 2)

    def one(x):
        xf = x.float()
        if mask is not None:
            mb = _bcast(mask.float(), xf)
            surv_mean = torch.sum(xf * mb, dim=0, keepdim=True) / torch.clamp(
                torch.sum(mask.float()), min=1.0)
            xf = torch.where(mb > 0, xf, surv_mean)
        xs = torch.sort(xf, dim=0).values
        kept = xs[k_trim:K - k_trim] if k_trim else xs
        return torch.mean(kept, dim=0).to(x.dtype)

    return tree_map(one, stacked)


def apply_update(global_tree, avg_h, scale=1.0):
    """Δw ← Δw + scale·h̄ (Algorithm 1 update), in fp32, cast back."""
    return tree_map(lambda w, h: (w.float() + scale * h.float()).to(w.dtype), global_tree, avg_h)


def broadcast(global_tree, K: int):
    """Fed-server broadcast: the global model in K client slots (views)."""
    return tree_map(lambda x: x[None].expand((K,) + tuple(x.shape)), global_tree)


# population size above which client_sample switches from the
# full-permutation draw to Floyd's O(cohort) sampling
SAMPLE_MIN_CLIENTS = 64


def client_sample(round_idx: int, num_clients: int, cohort: int, seed: int = 0) -> np.ndarray:
    """Per-round client sampling (elastic cohorts), sorted and without
    replacement; the reference's numpy draws, so bit-identical to it.

    ``num_clients ≤ SAMPLE_MIN_CLIENTS`` takes ``Generator.choice``; larger
    populations Floyd's algorithm on the same per-round stream: O(cohort)
    draws and memory, a pure function of ``(round_idx, seed)``.
    """
    rng = np.random.default_rng(seed * 1_000_003 + round_idx)
    size = min(cohort, num_clients)
    if num_clients <= SAMPLE_MIN_CLIENTS:
        return np.sort(rng.choice(num_clients, size=size, replace=False))
    chosen: set = set()
    for j in range(num_clients - size, num_clients):
        t = int(rng.integers(0, j + 1))
        chosen.add(t if t not in chosen else j)
    return np.fromiter(sorted(chosen), np.int64, count=size)


def deadline_mask(T_k: np.ndarray, deadline: float) -> np.ndarray:
    """Straggler mitigation: survivors are clients meeting the deadline."""
    return (np.asarray(T_k) <= deadline).astype(np.float32)
