"""Federated aggregation, the paper's fed-server role (port of
``repro/core/federated.py``).

Algorithm 1: Δw_c^(n+1) = Δw_c^(n) + (1/K)·Σ_k h_c,k^(n); the main server
applies the same update to its server-side adapters (Algorithm 2, last
line). Updates arrive as trees whose leaves are stacked (K, ...) over the
clients; every aggregator reduces that axis, in fp32, and casts back.

Fault tolerance: every aggregator takes a (K,) 0/1 survivor ``mask``, so a
round tolerates dropped or straggling clients (``deadline_mask``).
``hier_aggregate`` is the two-tier reduction of the ``edge-agg`` topology
(``net/topology.py``): per edge, then across edges.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_like, tree_map


def _bcast(v, x):
    """(K,) weights shaped to broadcast against a (K, ...) leaf."""
    return v.reshape((v.shape[0],) + (1,) * (x.ndim - 1))


def fma(a, b, c) -> torch.Tensor:
    """a·b + c in fp32 with one rounding, a fused multiply-add.

    The reference's fp32 weighted sums (``fedavg``, ``apply_update``) compile
    on the CPU into fused multiply-adds, so each step rounds once; torch
    rounds the product and the sum apart. In fp64 the product of two fp32
    values is exact; the sum is rounded to odd (truncated, its last bit set
    when inexact, from the TwoSum error), and the cast to fp32 then rounds
    the exact value correctly (53 ≥ 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    # s rounded away from the exact value when err points back towards 0
    t = torch.where((err != 0) & ((err < 0) != (s < 0)), torch.nextafter(s, torch.zeros_like(s)), s)
    odd = (t.view(torch.int64) | 1).view(torch.float64)
    return torch.where(err != 0, odd, t).float()


def weighted_sum(x, wn) -> torch.Tensor:
    """Σ_k wn_k·x_k over the leading axis of ``x``, in fp32, accumulated in k
    order by fused multiply-adds (the reference's reduction on the CPU).
    ``wn``: (K,), or (K, M) for M sums at once (an (M, ...) result)."""
    lead = () if wn.ndim == 1 else (wn.shape[1],)
    acc = torch.zeros(lead + tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
    for k in range(x.shape[0]):
        wk = wn[k] if wn.ndim == 1 else wn[k].reshape(lead + (1,) * (x.ndim - 1))
        acc = fma(x[k].float(), wk, acc)
    return acc


def _fused(fn, *trees, lead: int = 1):
    """``tree_map(lambda *xs: fn(*xs).to(xs[0].dtype), *trees)`` for an ``fn``
    that works element by element past the first ``lead`` axes, run once over
    all leaves instead of once per leaf: per dtype of the first tree's leaves,
    every tree's leaves are flattened past ``lead`` axes, concatenated and
    upcast to fp32; ``fn`` maps those (..., N) buffers to one (..., N) buffer,
    whose leading axes are its own (``weighted_sum`` reduces K to () or M).
    The result is cast once and split back into views, so the launch count
    does not grow with the number of leaves; the values are the per-leaf
    ones exactly."""
    leaves = [tree_leaves(t) for t in trees]
    out = [None] * len(leaves[0])
    groups: dict = {}
    for i, x in enumerate(leaves[0]):
        groups.setdefault(x.dtype, []).append(i)
    for dtype, idx in groups.items():
        bufs = [torch.cat([ls[i].reshape(tuple(ls[i].shape[:lead]) + (-1,)) for i in idx],
                          dim=-1).float() for ls in leaves]
        y = fn(*bufs).to(dtype)
        tails = [tuple(leaves[0][i].shape[lead:]) for i in idx]
        for i, t, chunk in zip(idx, tails, torch.split(y, [math.prod(t) for t in tails], dim=-1)):
            out[i] = chunk.view(tuple(y.shape[:-1]) + t)
    return tree_like(trees[0], out)


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
    return _fused(lambda x: weighted_sum(x, wn), stacked)


# the mean family takes hier_aggregate's batched fast path; it uses
# ``weights`` when given ("uniform" members ignore them)
fedavg.mean_family = "weighted"


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


staleness_weighted.mean_family = "weighted"


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


# edge count above which hier_aggregate's mean-family fast path switches
# from the batched masked sums (bit-identical to the unrolled per-edge path)
# to one scatter-add over the clients (O(K·leaf) memory, equal up to float
# associativity)
SEGMENT_MIN_EDGES = 32


def hier_aggregate(aggregate, stacked, assign, weights: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None):
    """Two-tier reduction: per-edge aggregate, then aggregate across edges.

    The ``edge-agg`` topology splits the fed-server role: each edge reduces
    its own clients' updates before the backhaul hop, the cloud reduces the
    edge aggregates. ``assign`` is the cohort's (K, M) one-hot membership.
    Both tiers use ``aggregate``: membership enters tier 1 as a mask (with
    the straggler mask), tier 2 weighs each edge by its surviving clients'
    total weight (empty cells are masked out). For (weighted) fedavg the
    result equals the flat reduction up to float associativity; robust
    aggregators become per-edge robust.

    Aggregators marked with ``mean_family`` ("weighted": uses ``weights``;
    "uniform": ignores them) take a fast path:

      * M ≤ ``SEGMENT_MIN_EDGES``: the unrolled path's masked sums, batched
        over the edge axis: the same fused multiply-adds in the same client
        order, so bit-identical to ``hier_aggregate_unrolled``;
      * M > ``SEGMENT_MIN_EDGES``: one scatter-add (``index_add_``) of the
        weighted updates into their edges, O(K·leaf) memory instead of
        O(M·K·leaf); equal to the unrolled path up to float associativity.

    Robust aggregators (median, trimmed mean) take the unrolled per-edge
    path: an order statistic has no segment reduction.
    """
    leaves = tree_leaves(stacked)
    if not leaves:
        return stacked
    K, M = assign.shape
    dev = leaves[0].device
    assign = assign.float()
    w = torch.ones(K, dtype=torch.float32, device=dev) if weights is None else weights.float()
    if mask is not None:
        w = w * mask.float()
    mode = getattr(aggregate, "mean_family", None)

    def edge_w():  # each edge's surviving weight, summed as the unrolled path sums it
        return torch.stack([torch.sum(w * assign[:, m]) for m in range(M)])

    if mode is not None:
        base = (torch.ones(K, dtype=torch.float32, device=dev)
                if (mode == "uniform" or weights is None) else weights.float())
        if M <= SEGMENT_MIN_EDGES:
            # (M, K) per-cell weights, multiplied and summed as the unrolled
            # fedavg calls do: base · (member · mask), one row at a time
            cell = assign.T if mask is None else assign.T * mask.float()[None, :]
            w1 = base[None, :] * cell
            denom = torch.stack([torch.clamp(torch.sum(row), min=1e-12) for row in w1])
            wn = w1 / denom[:, None]
            stacked_edges = _fused(lambda x: weighted_sum(x, wn.T), stacked)
            ew = edge_w()
        else:
            ids = torch.argmax(assign, dim=1)
            w1 = base if mask is None else base * mask.float()
            denom = torch.clamp(torch.zeros(M, device=dev).index_add_(0, ids, w1), min=1e-12)
            wn = w1 / denom[ids]

            def one(x):
                out = torch.zeros((M,) + tuple(x.shape[1:]), dtype=torch.float32, device=dev)
                return out.index_add_(0, ids, x.float() * _bcast(wn, x)).to(x.dtype)

            stacked_edges = tree_map(one, stacked)
            ew = torch.zeros(M, device=dev).index_add_(0, ids, w)
    else:
        per_edge = []
        for m in range(M):
            member = assign[:, m]
            cell_mask = member if mask is None else member * mask.float()
            per_edge.append(aggregate(stacked, weights=weights, mask=cell_mask))
        stacked_edges = tree_map(lambda *xs: torch.stack(xs), *per_edge)
        ew = edge_w()
    return aggregate(stacked_edges, weights=ew, mask=(ew > 0).float())


def hier_aggregate_unrolled(aggregate, stacked, assign, weights: Optional[torch.Tensor] = None,
                            mask: Optional[torch.Tensor] = None):
    """The unrolled two-tier reduction (M aggregate calls): the bit-equality
    oracle of the fast path, and the path of every aggregator without a
    ``mean_family`` marker."""
    return hier_aggregate(_strip_mean_family(aggregate), stacked, assign, weights=weights,
                          mask=mask)


def _strip_mean_family(aggregate):
    """``aggregate`` without its ``mean_family`` marker (forces the unrolled
    path), its arithmetic untouched."""

    def agg(stacked, weights=None, mask=None):
        return aggregate(stacked, weights=weights, mask=mask)

    return agg


def apply_update(global_tree, avg_h, scale=1.0):
    """Δw ← Δw + scale·h̄ (Algorithm 1 update), in fp32 (one fused
    multiply-add), cast back. ``scale``: a number or a 0-d tensor."""
    leaves = tree_leaves(avg_h)
    if not leaves:
        return global_tree
    s = torch.as_tensor(scale, dtype=torch.float32, device=leaves[0].device)
    return _fused(lambda w, h: fma(h, s, w), global_tree, avg_h, lead=0)


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
