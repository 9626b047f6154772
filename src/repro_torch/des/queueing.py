"""Shared-resource service models for the simulated system plane (port of
``repro/des/queueing.py``: the same numpy code, so the same waits).

The §III/§IV delay model prices every compute step and every *wireless*
transfer in isolation, and the queued backhaul modes close the loop on the
edge→cloud leg: with ``backhaul_model="fifo" | "ps"`` the composed path
re-times through a SHARED metro queue (this module), and the allocator's
per-cell convex solves fold the matching *expected* wait back into their
latency budgets (``repro_torch.net.allocation``'s wait-aware fixed point), so
contention is optimized against instead of assumed away.  The disciplines:

  * :func:`fifo` — a single-capacity first-come-first-served queue (the
    metro backhaul: one cell's burst delays the next cell's transfer);
  * :func:`processor_sharing` — egalitarian fluid sharing (a GPU or a
    statistically-multiplexed pipe: n concurrent jobs each progress at
    rate/n);
  * :func:`broadcast_seconds` — the downlink broadcast cost the paper
    treats as negligible: ONE multicast transmission per cell per round,
    every attached client pays the same wait.

All functions are pure numpy on host-side arrays — they plug into the
topology's per-hop delay composition (``net/topology.py`` with
``backhaul_model="fifo" | "ps"``).  :func:`md1_mean_wait` and
:func:`ps_mean_wait` are the textbook M/D/1 and M/G/1-PS queueing formulas
the simulated disciplines are sanity-checked against, and the analytic
expected-wait terms the wait-aware allocator prices with.
"""

from __future__ import annotations

import numpy as np


def service_seconds(bits, capacity_bps: float) -> np.ndarray:
    """Transfer time of each job on a ``capacity_bps`` link (inf at cap 0)."""
    bits = np.asarray(bits, float)
    if capacity_bps <= 0:
        return np.full_like(bits, np.inf)
    return bits / float(capacity_bps)


def fifo(arrivals, service) -> tuple[np.ndarray, np.ndarray]:
    """Single-server FIFO queue: ``(completion, wait)`` per job.

    Jobs are served in arrival order (ties broken by index — the same
    ``(time, seq)`` discipline as the event engine): job i starts at
    ``max(arrival_i, completion_of_previous)``.  ``wait`` is the queueing
    delay only (start − arrival), so ``completion = arrival + wait +
    service``.  Arrays come back in the ORIGINAL job order.

    Jobs with a non-finite arrival never reach the queue (an outage'd
    client whose wireless total is +inf): their completion and wait are
    +inf and they occupy no server time.
    """
    arrivals = np.asarray(arrivals, float)
    service = np.broadcast_to(np.asarray(service, float), arrivals.shape)
    order = np.argsort(arrivals, kind="stable")
    completion = np.full_like(arrivals, np.inf)
    wait = np.full_like(arrivals, np.inf)
    free_at = 0.0
    for i in order:
        if not np.isfinite(arrivals[i]):
            continue  # never arrives; +inf completion already set
        start = max(arrivals[i], free_at)
        wait[i] = start - arrivals[i]
        free_at = start + service[i]
        completion[i] = free_at
    return completion, wait


def processor_sharing(arrivals, demands, rate: float = 1.0) -> np.ndarray:
    """Egalitarian processor sharing: completion time per job.

    ``demands`` are in resource-seconds (or bits with ``rate`` in bits/s):
    while n jobs are in the system each progresses at ``rate / n``.  Solved
    exactly by fluid event stepping between arrivals/departures — at every
    step the job with the least remaining demand fixes the step length.
    Deterministic in its inputs (ties resolve by job index).  Jobs with a
    non-finite arrival never enter the system (completion +inf).
    """
    arrivals = np.asarray(arrivals, float)
    remaining = np.broadcast_to(np.asarray(demands, float),
                                arrivals.shape).copy()
    n = len(arrivals)
    completion = np.full(n, np.inf)
    if rate <= 0 or n == 0:
        return completion
    if not np.all(np.isfinite(arrivals)):
        finite = np.isfinite(arrivals)
        completion[finite] = processor_sharing(arrivals[finite],
                                               remaining[finite], rate)
        return completion
    # completion tolerance relative to the workload scale: a residue this
    # small cannot advance the clock by a representable step
    tol = 1e-9 * max(float(np.max(remaining)), 1e-300)
    order = np.argsort(arrivals, kind="stable")
    active: list[int] = []
    now = 0.0
    next_arrival = 0
    while next_arrival < n or active:
        if not active:  # idle until the next arrival
            now = arrivals[order[next_arrival]]
        # admit everything that has arrived by `now`
        while next_arrival < n and arrivals[order[next_arrival]] <= now:
            active.append(order[next_arrival])
            next_arrival += 1
        share = rate / len(active)
        # step to the earlier of: next arrival, first in-service completion
        first_done = min(active, key=lambda i: (remaining[i], i))
        t_done = now + remaining[first_done] / share
        t_next = arrivals[order[next_arrival]] if next_arrival < n else np.inf
        if t_next < t_done:
            drained = share * (t_next - now)
            now = t_next
        else:
            drained = share * (t_done - now)
            now = t_done
        for i in active:
            remaining[i] -= drained
        if t_next >= t_done:
            # we stepped exactly to first_done's finish — complete it
            # regardless of rounding residue (guards against a clock stall
            # when residue/share underflows below one ulp of `now`)
            remaining[first_done] = 0.0
        for i in [i for i in active if remaining[i] <= tol]:
            completion[i] = now
            active.remove(i)
    return completion


def broadcast_seconds(bits: float, capacity_bps: float) -> float:
    """Downlink broadcast: ONE multicast transmission serves every receiver.

    Unlike the uplink (per-client FDMA shares), the broadcast of the global
    model rides a single downlink transmission per cell — the cost is
    ``bits / capacity`` once, not per client.  ``capacity_bps <= 0`` means
    the term is disabled (the paper's negligible-downlink convention) and
    costs 0.
    """
    if capacity_bps <= 0:
        return 0.0
    return float(bits) / float(capacity_bps)


def md1_mean_wait(arrival_rate: float, service_s: float) -> float:
    """Analytic M/D/1 mean queueing wait  W_q = ρ·s / (2·(1−ρ)).

    Poisson arrivals at ``arrival_rate`` into a single FIFO server with
    DETERMINISTIC service time ``service_s`` (utilisation ρ = λ·s < 1).
    The reference the simulated FIFO backhaul is checked against at low
    utilisation (Pollaczek–Khinchine with zero service variance).
    """
    rho = arrival_rate * service_s
    if rho >= 1.0:
        return np.inf
    return rho * service_s / (2.0 * (1.0 - rho))


def ps_mean_wait(arrival_rate: float, service_s: float) -> float:
    """Analytic M/D/1-PS mean *extra* delay  W = ρ·s / (1−ρ).

    Poisson arrivals at ``arrival_rate`` into a single egalitarian
    processor-sharing server with service requirement ``service_s``
    (utilisation ρ = λ·s < 1).  M/G/1-PS mean sojourn is the insensitive
    s/(1−ρ) — independent of the service distribution, so it holds exactly
    for the deterministic demands the backhaul carries — and the *wait*
    (sojourn minus the job's own service) is ρ·s/(1−ρ).  The reference the
    simulated PS discipline is checked against at low utilisation, and the
    PS branch of the wait-aware allocator's expected-wait term.
    """
    rho = arrival_rate * service_s
    if rho >= 1.0:
        return np.inf
    return rho * service_s / (1.0 - rho)
