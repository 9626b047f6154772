"""Delay-minimisation resource allocation, paper §III-D/E, problems (16)/(17)
(port of ``repro/core/resource_alloc.py``: the same numpy/scipy code, so the
same (config, network) gives bit-identical allocations in both packages).

The paper reduces (16) to the convex problem (17) by fixing f*=f_max,
p*=p_max, A*=A_min, then sweeps η ∈ (0,1) in 0.01 steps solving (17) with
MATLAB fmincon (interior point).  We provide:

  * ``solve_fixed_eta_exact``  — beyond-paper exact structured solver:
      outer bisection on T; inner λ-weighted bandwidth balancing with
      per-user 1-D convex splits (vectorised golden section).  Exploits
      Lemma 3 (time budgets tight, rate constraints tight at optimum);
      ~10³× faster than the NLP route with the same optimum.
  * ``solve_fixed_eta_scipy``  — the faithful fmincon-equivalent (SLSQP on
      the full (T, t_c, t_s, b_c, b_s) program), used as the paper-faithful
      baseline and as a cross-check.
  * ``optimize``               — the η sweep + the paper's comparison
      strategies: 'proposed', 'EB' (equal bandwidth, optimise η),
      'FE' (fix η=0.1, optimise bandwidth), 'BA' (both fixed).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.config import FedsLLMConfig
from repro_torch.core import delay_model as dm

GOLD = (np.sqrt(5.0) - 1.0) / 2.0


@dataclass
class Allocation:
    T: float
    eta: float
    A: float
    t_c: np.ndarray
    t_s: np.ndarray
    b_c: np.ndarray
    b_s: np.ndarray
    feasible: bool
    strategy: str = "proposed"


# ---------------------------------------------------------------------------
# Inner problem: given T and η, can the bandwidth budgets support it?
# ---------------------------------------------------------------------------


def _split_costs(theta, R, V, s_c, s, net: dm.Network):
    """Bandwidths required for split θ (vectorised over K).

    t_c = θ·R;  t_s = (1-θ)·R/V  (budget tight — Lemma 3)."""
    t_c = np.maximum(theta * R, 1e-12)
    t_s = np.maximum((1.0 - theta) * R / V, 1e-12)
    b_c = dm.bandwidth_for_rate(s_c / t_c, net.g_c, net.p_c_max, net.N0)
    b_s = dm.bandwidth_for_rate(s / t_s, net.g_s, net.p_s_max, net.N0)
    return t_c, t_s, b_c, b_s


def _best_split(lmbda, R, V, s_c, s, net: dm.Network, iters: int = 32):
    """Per-user golden-section over θ for weighted cost
    λ·b_c/B_c + (1-λ)·b_s/B_s (convex in θ). Vectorised over users."""
    lo = np.full_like(R, 1e-6)
    hi = np.full_like(R, 1.0 - 1e-6)

    def cost(theta):
        _, _, b_c, b_s = _split_costs(theta, R, V, s_c, s, net)
        return lmbda * b_c / net.B_c + (1.0 - lmbda) * b_s / net.B_s

    for _ in range(iters):
        x1 = hi - GOLD * (hi - lo)
        x2 = lo + GOLD * (hi - lo)
        go_right = cost(x1) > cost(x2)
        lo = np.where(go_right, x1, lo)
        hi = np.where(go_right, hi, x2)
    theta = 0.5 * (lo + hi)
    return theta


def _feasibility(T, cfg: FedsLLMConfig, net: dm.Network, eta: float, A: float,
                 model_params, lam_iters: int = 12, extra_delay=None):
    """min over λ of max(Σb_c/B_c, Σb_s/B_s) at latency target T.

    ``extra_delay`` is an optional (K,) per-user fixed latency already
    committed outside the wireless hop (the wait-aware allocator's expected
    backhaul wait+service): it tightens each user's budget exactly like the
    compute time does, ``R = T/I0 − τ − extra``.  ``None`` keeps the
    legacy wireless-only budget bit-identical.
    """
    I0 = dm.global_rounds(cfg, eta)
    V = dm.local_iters(cfg, eta)
    tau = dm.compute_time(cfg, net, eta, A, model_params)
    if extra_delay is not None:
        tau = tau + np.asarray(extra_delay, float)
    R = T / I0 - tau
    if np.any(R <= 0):
        return np.inf, None
    s_c, s = cfg.s_c_bits, cfg.s_bits

    def usage(lmbda):
        theta = _best_split(lmbda, R, V, s_c, s, net)
        t_c, t_s, b_c, b_s = _split_costs(theta, R, V, s_c, s, net)
        return np.sum(b_c) / net.B_c, np.sum(b_s) / net.B_s, (t_c, t_s, b_c, b_s)

    lo, hi = 0.0, 1.0
    best = None
    best_val = np.inf
    for _ in range(lam_iters):
        mid = 0.5 * (lo + hi)
        u_c, u_s, alloc = usage(mid)
        val = max(u_c, u_s)
        if val < best_val:
            best_val, best = val, alloc
        # raise weight on the busier budget
        if u_c > u_s:
            lo = mid
        else:
            hi = mid
    return best_val, best


def solve_fixed_eta_exact(cfg: FedsLLMConfig, net: dm.Network, eta: float,
                          A: Optional[float] = None, model_params=None,
                          T_hi: Optional[float] = None, iters: int = 30,
                          extra_delay=None) -> Allocation:
    """Bisection on T; inner bandwidth-balancing feasibility (exact).

    ``extra_delay`` (optional (K,)) shrinks each user's per-round budget by
    a fixed latency committed elsewhere on its path — the wait-aware
    allocator's expected backhaul term; ``None`` is the legacy
    wireless-only problem, bit-identical.
    """
    A = cfg.split_ratio_min if A is None else A  # paper: A* = A_min
    I0 = dm.global_rounds(cfg, eta)
    tau = dm.compute_time(cfg, net, eta, A, model_params)
    if extra_delay is not None:
        tau = tau + np.asarray(extra_delay, float)
    T_lo = I0 * np.max(tau)
    if T_hi is None:
        eb = solve_equal_bandwidth(cfg, net, eta, A, model_params)
        T_hi = eb.T * 1.001 if np.isfinite(eb.T) else I0 * np.max(tau) * 1e4 + 1e3
    # ensure hi feasible
    val, alloc = _feasibility(T_hi, cfg, net, eta, A, model_params,
                              extra_delay=extra_delay)
    grow = 0
    while val > 1.0 and grow < 40:
        T_hi *= 2.0
        val, alloc = _feasibility(T_hi, cfg, net, eta, A, model_params,
                                  extra_delay=extra_delay)
        grow += 1
    if val > 1.0:
        return Allocation(np.inf, eta, A, None, None, None, None, False)
    for _ in range(iters):
        if T_hi - T_lo < 1e-5 * T_hi:
            break
        mid = 0.5 * (T_lo + T_hi)
        val, a = _feasibility(mid, cfg, net, eta, A, model_params,
                              extra_delay=extra_delay)
        if val <= 1.0:
            T_hi, alloc = mid, a
        else:
            T_lo = mid
    t_c, t_s, b_c, b_s = alloc
    return Allocation(T_hi, eta, A, t_c, t_s, b_c, b_s, True)


# ---------------------------------------------------------------------------
# Equal-bandwidth closed form (EB / BA baselines)
# ---------------------------------------------------------------------------


def solve_equal_bandwidth(cfg: FedsLLMConfig, net: dm.Network, eta: float,
                          A: Optional[float] = None, model_params=None) -> Allocation:
    A = cfg.split_ratio_min if A is None else A
    K = net.K
    b_c = np.full(K, net.B_c / K)
    b_s = np.full(K, net.B_s / K)
    r_c = dm.rate(b_c, net.g_c, net.p_c_max, net.N0)
    r_s = dm.rate(b_s, net.g_s, net.p_s_max, net.N0)
    t_c = cfg.s_c_bits / r_c
    t_s = cfg.s_bits / r_s
    T_k = dm.round_latency(cfg, net, eta, A, t_c, t_s, model_params)
    return Allocation(float(np.max(T_k)), eta, A, t_c, t_s, b_c, b_s, True, "EB")


# ---------------------------------------------------------------------------
# Faithful NLP solver (fmincon interior-point equivalent)
# ---------------------------------------------------------------------------


def solve_fixed_eta_scipy(cfg: FedsLLMConfig, net: dm.Network, eta: float,
                          A: Optional[float] = None, model_params=None,
                          x0: Optional[np.ndarray] = None,
                          extra_delay=None) -> Allocation:
    """Problem (17) as stated: vars x = [T, t_c(K), t_s(K), b_c(K), b_s(K)]."""
    from scipy.optimize import NonlinearConstraint, LinearConstraint, minimize

    A = cfg.split_ratio_min if A is None else A
    K = net.K
    I0 = dm.global_rounds(cfg, eta)
    V = dm.local_iters(cfg, eta)
    tau = dm.compute_time(cfg, net, eta, A, model_params)
    if extra_delay is not None:
        tau = tau + np.asarray(extra_delay, float)
    s_c, s = cfg.s_c_bits, cfg.s_bits

    def unpack(x):
        return x[0], x[1:1 + K], x[1 + K:1 + 2 * K], x[1 + 2 * K:1 + 3 * K], x[1 + 3 * K:]

    def f_obj(x):
        return x[0]

    def g_latency(x):  # T/I0 - tau - t_c - V t_s >= 0
        T, t_c, t_s, _, _ = unpack(x)
        return T / I0 - tau - t_c - V * t_s

    def g_rate_s(x):  # t_s * r(b_s) - s >= 0
        _, _, t_s, _, b_s = unpack(x)
        return t_s * dm.rate(b_s, net.g_s, net.p_s_max, net.N0) - s

    def g_rate_c(x):
        _, t_c, _, b_c, _ = unpack(x)
        return t_c * dm.rate(b_c, net.g_c, net.p_c_max, net.N0) - s_c

    def g_bw(x):
        _, _, _, b_c, b_s = unpack(x)
        return np.array([net.B_c - np.sum(b_c), net.B_s - np.sum(b_s)])

    if x0 is None:
        eb = solve_equal_bandwidth(cfg, net, eta, A, model_params)
        x0 = np.concatenate([[eb.T * 1.05], eb.t_c * 1.05, eb.t_s * 1.05, eb.b_c, eb.b_s])

    cons = [
        {"type": "ineq", "fun": g_latency},
        {"type": "ineq", "fun": g_rate_s},
        {"type": "ineq", "fun": g_rate_c},
        {"type": "ineq", "fun": g_bw},
    ]
    bounds = [(0.0, None)] * (1 + 4 * K)
    res = minimize(f_obj, x0, method="SLSQP", constraints=cons, bounds=bounds,
                   options={"maxiter": 400, "ftol": 1e-10})
    T, t_c, t_s, b_c, b_s = unpack(res.x)
    return Allocation(float(T), eta, A, t_c, t_s, b_c, b_s, bool(res.success), "scipy")


# ---------------------------------------------------------------------------
# η sweep + comparison strategies (paper §IV)
# ---------------------------------------------------------------------------


def quantize_eta(eta: float, bucket: float = 0.05,
                 eta_max: float = 0.5) -> float:
    """Snap a solved η* onto the training-η bucket grid, clamped to
    [bucket, eta_max].

    A round function depends on η through Lemma 2's local iteration count,
    so a campaign that adopts every round's exact η* would build a new one
    every round.  Quantizing to a coarse grid bounds the number of distinct
    round functions by the number of buckets.
    """
    if bucket <= 0:
        raise ValueError(f"eta bucket must be positive, got {bucket}")
    q = round(round(float(eta) / bucket) * bucket, 10)
    return float(np.clip(q, bucket, eta_max))


def eta_grid_for(cfg: FedsLLMConfig, eta_search: str = "grid",
                 eta0: Optional[float] = None) -> np.ndarray:
    """The η candidate grid an ``eta_search`` mode sweeps.

    Shared by :func:`optimize` and the hierarchical per-cell optimiser
    (``repro_torch.net.allocation``) so both sweep byte-identical grids: 'grid' is
    the paper-faithful 0.01 step, 'coarse' a 0.05 step (refined locally by
    the caller), 'warm' a ±5·eta_step window around ``eta0``.
    """
    if eta_search == "warm":
        if eta0 is None:
            raise ValueError("eta_search='warm' requires eta0= "
                             "(the anchor of the local window)")
        step = cfg.eta_step
        lo = max(step, eta0 - 5.0 * step)
        hi = min(1.0 - step, eta0 + 5.0 * step)
        return np.arange(lo, hi + step / 2.0, step)
    if eta_search == "coarse":
        return np.arange(0.05, 1.0, 0.05)
    return np.arange(cfg.eta_step, 1.0, cfg.eta_step)


def eta_refine_grid(cfg: FedsLLMConfig, eta: float) -> np.ndarray:
    """The local ``eta_step``-step window the 'coarse' mode refines around
    its sweep argmin — shared by :func:`optimize` and the per-cell optimiser
    so both refine byte-identical grids."""
    step = cfg.eta_step
    lo = max(step, eta - 0.05)
    hi = min(1.0 - step, eta + 0.05)
    return np.arange(lo, hi + step / 2.0, step)


def optimize(cfg: FedsLLMConfig, net: dm.Network, strategy: str = "proposed",
             model_params=None, eta_grid: Optional[np.ndarray] = None,
             solver: str = "exact", eta_search: str = "grid",
             eta0: Optional[float] = None,
             extra_delay: Optional[np.ndarray] = None) -> Allocation:
    """Full optimiser.  strategy ∈ {proposed, EB, FE, BA}.

    ``extra_delay`` — optional (K,) fixed per-user latency committed outside
    the wireless hop (the wait-aware allocator's expected backhaul
    wait+service); only the 'proposed' solver responds to it (the EB/FE/BA
    baselines stay wait-blind by design).

    eta_search='grid' is the paper-faithful 0.01-step sweep; 'coarse' runs a
    0.05-step sweep + one 0.01-step local refinement around the argmin
    (identical optimum on smooth T(η), ~6× fewer solves — used by the
    benchmark harness); 'warm' sweeps only a ±5·eta_step window around a
    previously solved ``eta0`` (the per-round joint re-solve of the campaign
    engine: block fading moves T(η) but barely moves its argmin, so a local
    window finds the same optimum ~10× cheaper — and, unlike warm-starting
    from the *previous round's* solve, stays a pure function of the round,
    which checkpoint resume requires)."""
    if eta_grid is None:
        eta_grid = eta_grid_for(cfg, eta_search, eta0)
    fixed_eta = 0.1  # paper: FE/BA fix η = 0.1

    if strategy == "BA":
        return solve_equal_bandwidth(cfg, net, fixed_eta, model_params=model_params)
    if strategy == "FE":
        fn = solve_fixed_eta_exact if solver == "exact" else solve_fixed_eta_scipy
        a = fn(cfg, net, fixed_eta, model_params=model_params)
        return dataclasses.replace(a, strategy="FE")
    if strategy == "EB":
        best = None
        for eta in eta_grid:
            a = solve_equal_bandwidth(cfg, net, float(eta), model_params=model_params)
            if best is None or a.T < best.T:
                best = a
        return dataclasses.replace(best, strategy="EB")
    if strategy == "proposed":
        fn = solve_fixed_eta_exact if solver == "exact" else solve_fixed_eta_scipy
        best = None
        for eta in eta_grid:
            eta = float(eta)
            if solver == "exact" and best is not None:
                # prune: if the incumbent T* is infeasible at this η, this η
                # cannot improve on it (T(η) would exceed T*) — one cheap check
                val, _ = _feasibility(best.T, cfg, net, eta, cfg.split_ratio_min,
                                      model_params, extra_delay=extra_delay)
                if val > 1.0:
                    continue
                a = fn(cfg, net, eta, model_params=model_params,
                       T_hi=best.T * 1.0001, extra_delay=extra_delay)
            else:
                a = fn(cfg, net, eta, model_params=model_params,
                       extra_delay=extra_delay)
            if a.feasible and (best is None or a.T < best.T):
                best = a
        if eta_search == "coarse" and best is not None:
            for eta in eta_refine_grid(cfg, best.eta):
                eta = float(eta)
                val, _ = _feasibility(best.T, cfg, net, eta, cfg.split_ratio_min,
                                      model_params, extra_delay=extra_delay)
                if val > 1.0:
                    continue
                a = fn(cfg, net, eta, model_params=model_params,
                       T_hi=best.T * 1.0001, extra_delay=extra_delay)
                if a.feasible and a.T < best.T:
                    best = a
        return dataclasses.replace(best, strategy="proposed")
    raise ValueError(strategy)
