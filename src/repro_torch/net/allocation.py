"""Topology-aware resource allocation: problems (16)/(17) per edge cell (port
of ``repro/net/allocation.py``).

At a fixed η the paper's convex problem (17) decomposes over a hierarchical
graph: each edge owns an independent copy of the bandwidth pool (spatial
reuse — cells don't interfere in the FDMA model), so each cell is exactly
the flat problem restricted to its own clients and is solved by the
**existing** Lemma-3 machinery (``core.resource_alloc``).  What does NOT
decompose is the η sweep: Lemma 1/2's global-round and local-iteration
schedule is shared by every client, and the objective is the hierarchical
critical path

    T(η) = I0(η) · max_k ( τ_k(η) + t_c,k + V(η)·t_s,k + backhaul_{edge(k)}(η) )

(backhaul included — for ``relay`` it even depends on η through V).  So the
sweep lives at the topology level: for each candidate η, solve every cell
independently at that η, scatter the per-cell solutions back into (K,)
arrays, price the combined allocation under the hierarchical timing, and
keep the best.  ``eta_search`` modes ('grid' / 'coarse' / 'warm') reuse the
same grids as the flat ``optimize`` (``eta_grid_for``), so the campaign's
warm per-round re-solve works identically on every topology.

Under a QUEUED backhaul (``backhaul_model="fifo" | "ps"``) the edge→cloud
leg is a shared metro queue and the backhaul term above becomes each
client's own wait + service in that queue — a function of every cell's
arrival pattern, which the per-cell convex solves themselves determine.
The 'proposed' strategy therefore closes the allocator↔queueing loop with
a damped fixed point at each candidate η (:func:`solve_wait_aware`): solve
the cells with a per-client *expected-wait* term ``w_k`` folded into their
latency budgets (``R_k = T/I0 − τ_k − w_k``), re-derive ``w`` from the
candidate's own wireless completion times via the analytic
``queueing.md1_mean_wait`` (FIFO) / ``queueing.ps_mean_wait`` (PS) models,
and iterate to a fixed point under a deterministic iteration cap.  Every
iterate — including the wait-blind first one — is priced through the TRUE
queued ``topology.round_timing`` and the best survives, so the wait-aware
solution is never worse than the wait-blind one at any η.  With
``backhaul_model="serial"`` none of this runs and the solve is
bit-identical to the legacy allocator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.config import FedsLLMConfig
from repro_torch.core import delay_model as dm
from repro_torch.core import fedsllm
from repro_torch.core import resource_alloc as ra
from repro_torch.core.resource_alloc import Allocation
from repro_torch.des import queueing


def subnetwork(net: dm.Network, idx: np.ndarray) -> dm.Network:
    """The network restricted to clients ``idx``, keeping the full bandwidth
    pools (each cell owns an independent copy — spatial reuse)."""
    take = lambda a: None if a is None else np.asarray(a)[idx]  # noqa: E731
    return dataclasses.replace(
        net, g_c=take(net.g_c), g_s=take(net.g_s), C_k=take(net.C_k),
        D_k=take(net.D_k), f_max=take(net.f_max), p_c_max=take(net.p_c_max),
        p_s_max=take(net.p_s_max), xy=take(net.xy), pl_db=take(net.pl_db))


def _infeasible(fcfg: FedsLLMConfig, strategy: str) -> Allocation:
    """The nothing-worked sentinel: ``T=+inf``, ``eta=nan``.

    η is NaN on purpose — an infeasible round has no solved η*, and a
    fabricated finite value could silently be adopted as a training η by a
    reallocating campaign (``Experiment.set_eta`` and the round-state guard
    both reject non-finite η with a loud error instead)."""
    return Allocation(np.inf, np.nan, fcfg.split_ratio_min, None, None, None,
                      None, False, strategy)


def _transmit_time(bits: float, rate: np.ndarray) -> np.ndarray:
    """bits/rate with rate→0 treated as an outage (+inf, a sure straggler)."""
    rate = np.asarray(rate, float)
    out = np.full_like(rate, np.inf)
    np.divide(bits, rate, out=out, where=rate > 0)
    return out


def _broadcast_reps(fcfg: FedsLLMConfig, net: dm.Network, idx: np.ndarray,
                    rep_idx: np.ndarray, a: Allocation) -> Allocation:
    """Expand a representative-cell solve to the full cell.

    Each non-representative member adopts the bandwidth split of its nearest
    representative in client-side channel gain (the Lemma-3 split is
    monotone in gain, so the nearest-gain rep's share is the right
    multiplicity class), re-timed at the member's OWN gains — the combined
    allocation still prices every client's real link, only the convex solve
    was restricted."""
    g = np.asarray(net.g_c, float)
    order = np.argsort(g[rep_idx], kind="stable")
    rg = g[rep_idx][order]
    pos = np.searchsorted(rg, g[idx])
    lo = np.clip(pos - 1, 0, len(rg) - 1)
    hi = np.clip(pos, 0, len(rg) - 1)
    nearer = np.where(np.abs(g[idx] - rg[lo]) <= np.abs(rg[hi] - g[idx]),
                      lo, hi)
    src = order[nearer]
    b_c = np.asarray(a.b_c)[src]
    b_s = np.asarray(a.b_s)[src]
    r_c = dm.rate(b_c, g[idx], np.asarray(net.p_c_max)[idx], net.N0)
    r_s = dm.rate(b_s, np.asarray(net.g_s)[idx],
                  np.asarray(net.p_s_max)[idx], net.N0)
    return dataclasses.replace(a, b_c=b_c, b_s=b_s,
                               t_c=_transmit_time(fcfg.s_c_bits, r_c),
                               t_s=_transmit_time(fcfg.s_bits, r_s))


def _solve_cell(fcfg: FedsLLMConfig, net: dm.Network, idx: np.ndarray,
                allocate_fn, *, population=None,
                extra_delay: Optional[np.ndarray] = None,
                **cell_kw) -> tuple:
    """One cell's convex solve, population-aware: ``(idx, Allocation)``.

    Without a population holding ``rep_ids`` (exact/compact, or mean-field
    with reps ≥ K) this is exactly the legacy per-cell call — bit-identical.
    With representatives, the solve runs on the cell's reps only, with the
    cell's bandwidth pool scaled by the representative fraction so each rep
    stands in for its multiplicity share of the population (the per-client
    share of the pool is preserved in expectation); the solution is then
    broadcast back to every member via :func:`_broadcast_reps`.  Cells whose
    representatives don't cover them (no rep attached) fall back to the
    exact solve.
    """
    rep = getattr(population, "rep_ids", None)
    sub_idx = idx
    if rep is not None:
        rep_in = np.intersect1d(idx, rep)
        if 0 < len(rep_in) < len(idx):
            fcfg = dataclasses.replace(
                fcfg, bandwidth_total_hz=(fcfg.bandwidth_total_hz
                                          * len(rep_in) / len(idx)))
            sub_idx = rep_in
    if extra_delay is not None:
        cell_kw["extra_delay"] = np.asarray(extra_delay)[sub_idx]
    a = allocate_fn(fcfg, subnetwork(net, sub_idx), **cell_kw)
    if sub_idx is not idx and a.feasible and a.t_c is not None:
        a = _broadcast_reps(fcfg, net, idx, sub_idx, a)
    return idx, a


def _combine(fcfg: FedsLLMConfig, net: dm.Network, assign: np.ndarray,
             topology, solved: list, eta: float,
             strategy: str, population=None) -> Optional[Allocation]:
    """Scatter per-cell solutions into (K,) arrays and price the combined
    allocation under the hierarchical critical path.  None if any cell was
    infeasible at this η.

    The critical path maxes over FINITE clients only: an outage'd client
    (+inf end-to-end total) is exactly the one the campaign's deadline mask
    drops, and letting it poison every η candidate with ``T=+inf`` would
    degenerate the sweep into silently keeping the first grid point.  +inf
    is returned only when NO client is finite."""
    K = net.K
    t_c, t_s = np.zeros(K), np.zeros(K)
    b_c, b_s = np.zeros(K), np.zeros(K)
    for idx, a in solved:
        if not a.feasible or a.t_c is None:
            return None
        t_c[idx], t_s[idx] = a.t_c, a.t_s
        b_c[idx], b_s[idx] = a.b_c, a.b_s
    alloc = Allocation(np.inf, eta, fcfg.split_ratio_min, t_c, t_s, b_c, b_s,
                       True, strategy)
    timing = topology.round_timing(fcfg, net, alloc, eta, assign,
                                   population=population)
    total = np.asarray(timing.total, float)
    finite = total[np.isfinite(total)]
    worst = float(np.max(finite)) if finite.size else np.inf
    T = dm.global_rounds(fcfg, eta) * worst
    return dataclasses.replace(alloc, T=T)


def cell_latency(fcfg: FedsLLMConfig, net: dm.Network, alloc: Allocation,
                 assign: np.ndarray, topology, eta: float) -> np.ndarray:
    """(M,) total training latency of each cell under ``alloc`` — the
    per-cell version of the paper's T (empty cells are NaN).  The per-cell
    comparison of the proposed allocator vs the BA baseline reports this."""
    timing = topology.round_timing(fcfg, net, alloc, eta, assign)
    I0 = dm.global_rounds(fcfg, eta)
    out = np.full(topology.num_edges, np.nan)
    for m in range(topology.num_edges):
        members = np.asarray(assign) == m
        if np.any(members):
            out[m] = I0 * float(np.max(np.asarray(timing.total)[members]))
    return out


# ---------------------------------------------------------------------------
# Wait-aware allocation: close the allocator↔queueing loop (fifo / ps)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WaitInfo:
    """Diagnostics of one :func:`solve_wait_aware` fixed point (one η)."""

    eta: float
    iters: int
    converged: bool
    max_delta: float


def expected_backhaul_hop(fcfg: FedsLLMConfig, net: dm.Network,
                          assign: np.ndarray, topology, eta: float,
                          wireless_total: np.ndarray) -> np.ndarray:
    """(K,) analytic *expected* backhaul hop (queueing wait + own service)
    per client under the shared metro queue, for a candidate allocation's
    wireless completion times.

    Each cell's contribution to the queue's load is derived from the
    candidate itself: its jobs (``topology._backhaul_jobs`` — per client for
    edge-cloud/relay, one pre-aggregated delta per edge for edge-agg) arrive
    over the window spanned by the wireless completions, giving the shared
    queue an aggregate arrival rate λ = Σ_m n_m / span.  The mean wait is
    the validated analytic model — M/D/1 (``md1_mean_wait``) for FIFO,
    M/D/1-PS (``ps_mean_wait``) for PS — capped at the all-at-once batch
    backlog ``(n−1)·s̄/2`` so a saturated window (ρ ≥ 1 over the span)
    prices the bounded per-round burst rather than a steady-state +inf.
    The mean is distributed over the jobs as a linear ramp in arrival rank
    (later arrivals expect proportionally more backlog), which is what lets
    the per-cell solves *stagger* completions instead of bursting the queue
    with a simultaneous batch.  Clients whose wireless total is non-finite
    never reach the queue and get hop 0 (matching ``_queued_backhaul``).
    """
    totals = np.asarray(wireless_total, float)
    arrivals, bits, job_of = topology._backhaul_jobs(fcfg, assign, eta,
                                                     totals)
    service = queueing.service_seconds(bits, topology.backhaul_bps)
    finite = np.isfinite(arrivals)
    n = int(np.count_nonzero(finite))
    hop_jobs = np.zeros(len(arrivals))
    if n:
        s_bar = float(np.mean(service[finite]))
        if n > 1 and s_bar > 0:
            span = float(np.max(arrivals[finite]) - np.min(arrivals[finite]))
            lam = n / span if span > 0 else np.inf
            mean_wait = (queueing.ps_mean_wait(lam, s_bar)
                         if topology.backhaul_model == "ps"
                         else queueing.md1_mean_wait(lam, s_bar))
            mean_wait = min(mean_wait, 0.5 * (n - 1) * s_bar)
            ranks = np.empty(n)
            ranks[np.argsort(arrivals[finite], kind="stable")] = np.arange(n)
            wait = mean_wait * 2.0 * ranks / (n - 1)
            hop_jobs[finite] = wait + service[finite]
        else:
            hop_jobs[finite] = service[finite]
    hop = hop_jobs[job_of]
    hop[~np.isfinite(totals)] = 0.0
    return hop


def solve_wait_aware(fcfg: FedsLLMConfig, net: dm.Network,
                     assign: np.ndarray, topology, allocate_fn, eta: float, *,
                     strategy: str = "proposed", model_params=None,
                     population=None,
                     **kw) -> tuple[Optional[Allocation], WaitInfo]:
    """The damped allocation↔wait fixed point at one fixed η.

    Iterate: solve every cell with the current per-client expected-wait
    term ``w`` folded into its latency budget (``extra_delay`` of the
    Lemma-3 solver), re-derive ``w`` from the candidate's wireless
    completion times (:func:`expected_backhaul_hop`), damp
    (``w ← (1−γ)·w + γ·w_new``, γ = ``topology.wait_damping``) and repeat
    under the deterministic cap ``topology.wait_iters``.  Iterate 0 runs
    with no wait term — the exact wait-blind solve — and every iterate is
    priced through the true queued ``round_timing`` (``_combine``), with
    the best kept: the result can only improve on the wait-blind
    allocation.

    Convergence is declared on the OBJECTIVE, not the raw wait vector: the
    loop stops (a) immediately after the blind iterate when the expected
    hop is negligible against the round's critical path (an uncontended
    queue can't move the optimum beyond the solver's own tolerance — this
    keeps default-capacity graphs at one extra hop evaluation), or (b) when
    an iterate fails to improve the incumbent's true-priced T by more than
    0.01% (the rank-based wait map can cycle between equivalent staggerings
    under heavy contention, but the allocations it produces stop improving
    — that plateau IS the fixed point of the objective).

    Returns ``(best_candidate_or_None, WaitInfo)``; pure in its arguments
    (no RNG, numpy-deterministic), so campaigns that re-solve per round
    stay pure functions of ``(RunConfig, seed)``.
    """
    cells = [np.where(np.asarray(assign) == m)[0]
             for m in range(topology.num_edges)]
    cells = [idx for idx in cells if len(idx)]
    eta = float(eta)

    def solve(extra: Optional[np.ndarray]) -> Optional[Allocation]:
        solved = [_solve_cell(fcfg, net, idx, allocate_fn,
                              population=population, extra_delay=extra,
                              model_params=model_params,
                              eta_grid=np.array([eta]), **kw)
                  for idx in cells]
        return _combine(fcfg, net, assign, topology, solved, eta, strategy,
                        population=population)

    cap = int(getattr(topology, "wait_iters", 8))
    damping = float(getattr(topology, "wait_damping", 0.5))
    rtol = 1e-4  # matches the exact solver's own bisection tolerance scale
    w = np.zeros(net.K)
    best: Optional[Allocation] = None
    info = WaitInfo(eta=eta, iters=0, converged=False, max_delta=np.inf)
    for it in range(cap):
        cand = solve(None if it == 0 else w)
        info.iters = it + 1
        if cand is None:
            # a cell went infeasible under the current wait estimate; the
            # best earlier iterate stands (None only if η itself infeasible)
            break
        if best is not None and not cand.T < best.T * (1.0 - rtol):
            # the loop stopped producing better allocations — the
            # objective's fixed point (see the docstring)
            if cand.T < best.T:
                best = cand
            info.converged = True
            break
        best = cand if best is None or cand.T < best.T else best
        wireless = np.asarray(
            fedsllm.simulate_round_time(fcfg, net, cand, eta).total, float)
        w_new = expected_backhaul_hop(fcfg, net, assign, topology, eta,
                                      wireless)
        info.max_delta = float(np.max(np.abs(w_new - w)))
        finite = wireless[np.isfinite(wireless)]
        round_scale = float(np.max(finite)) if finite.size else 0.0
        if float(np.max(w_new)) <= rtol * round_scale:
            # uncontended queue: the whole hop is below the solver's
            # tolerance on the critical path — the blind solve stands
            info.converged = True
            break
        w = (1.0 - damping) * w + damping * w_new
    return best, info


def optimize_cells(fcfg: FedsLLMConfig, net: dm.Network,
                   assign: np.ndarray, topology, allocate_fn, *,
                   strategy: str = "proposed", model_params=None,
                   eta_search: str = "grid", eta0: Optional[float] = None,
                   population=None,
                   **kw) -> Allocation:
    """Per-edge-cell (16)/(17): topology-level η sweep, independent convex
    cell subproblems at each fixed η (see the module docstring).

    ``allocate_fn`` is the experiment's registered allocator strategy —
    called per cell with a single-η grid, so every strategy branch
    ('proposed' exact solver, 'EB' closed form, …) works per cell unchanged.
    'BA'/'FE' pin η = 0.1 themselves, so they need no sweep at all.

    Under a queued backhaul (``topology.backhaul_model`` 'fifo'/'ps' with
    ``topology.wait_aware`` true) the 'proposed' strategy solves each η via
    the wait-aware fixed point (:func:`solve_wait_aware`); per-η
    :class:`WaitInfo` diagnostics land on ``topology.wait_diag``.  The
    EB/FE/BA baselines stay wait-blind by design (their sweep still prices
    the true queue through ``round_timing``), and ``"serial"`` keeps the
    legacy path bit-identical.
    """
    cells = [np.where(np.asarray(assign) == m)[0]
             for m in range(topology.num_edges)]
    cells = [idx for idx in cells if len(idx)]

    if strategy in ("BA", "FE"):  # fixed η = 0.1, one solve per cell
        solved = [_solve_cell(fcfg, net, idx, allocate_fn,
                              population=population,
                              model_params=model_params, **kw)
                  for idx in cells]
        combined = _combine(fcfg, net, assign, topology, solved, 0.1,
                            strategy, population=population)
        return combined if combined is not None else _infeasible(fcfg, strategy)

    wait_aware = (strategy == "proposed"
                  and getattr(topology, "backhaul_model", "serial") != "serial"
                  and getattr(topology, "wait_aware", True))
    if wait_aware:
        topology.wait_diag = []

    def solve_at(eta: float) -> Optional[Allocation]:
        if wait_aware:
            cand, diag = solve_wait_aware(fcfg, net, assign, topology,
                                          allocate_fn, eta, strategy=strategy,
                                          model_params=model_params,
                                          population=population, **kw)
            topology.wait_diag.append(diag)
            return cand
        solved = [_solve_cell(fcfg, net, idx, allocate_fn,
                              population=population,
                              model_params=model_params,
                              eta_grid=np.array([eta]), **kw)
                  for idx in cells]
        return _combine(fcfg, net, assign, topology, solved, eta, strategy,
                        population=population)

    best = None
    for eta in ra.eta_grid_for(fcfg, eta_search, eta0):
        cand = solve_at(float(eta))
        if cand is not None and (best is None or cand.T < best.T):
            best = cand
    if eta_search == "coarse" and best is not None:
        # the same local eta_step refinement the flat optimiser applies
        for eta in ra.eta_refine_grid(fcfg, best.eta):
            cand = solve_at(float(eta))
            if cand is not None and cand.T < best.T:
                best = cand
    return best if best is not None else _infeasible(fcfg, strategy)
