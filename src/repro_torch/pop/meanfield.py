"""Mean-field population: O(cohort) timelines and analytic queue pricing (port
of ``repro/pop/meanfield.py``: the same numpy code).

``meanfield`` extends ``compact`` (same fixed-window device compaction)
with three host-side reductions, so a 10⁵-client campaign's per-round cost
stops scaling with K everywhere, not just on the device:

  * **representative timeline** — only a seeded, campaign-fixed set of C
    representative clients launches in the discrete-event timeline
    (``AsyncSchedule.planner`` restricts its launch set through
    ``timeline_clients()``), so the event heap holds O(C) entries instead
    of O(K);
  * **analytic queue pricing** — the FIFO/PS shared-backhaul hop is priced
    by :func:`meanfield_backhaul_hop` instead of the exact per-job queue
    simulation (``HierTopology._queued_backhaul`` — an O(K) python loop for
    FIFO, O(K²)-ish fluid stepping for PS): the K−C non-representative
    clients are modelled as per-cell arrival-rate processes feeding the
    shared queue, and each job's wait comes from the validated analytic
    M/D/1 (``queueing.md1_mean_wait``) / PS (``queueing.ps_mean_wait``)
    references, capped at the all-at-once batch backlog;
  * **representative allocation** — under ``reallocate=True`` each edge
    cell's (16)/(17) solve runs on its representative members only, with
    the cell bandwidth pool scaled by the representative fraction
    (population multiplicities), and every non-representative member adopts
    its nearest representative's bandwidth share re-timed at its own gains
    (``repro_torch.net.allocation._solve_cell``).

**Validity regime.**  The mean-field queue model is accurate when (a) the
per-round backhaul utilisation ρ = λ·s̄ is below ~1 over each cell's
arrival span — above it the analytic wait is capped at the batch backlog
((n−1)·s̄/2 for FIFO, (n−1)·s̄ for PS), which is exact for a simultaneous
equal-service batch — and (b) the cohort fraction C/K is small enough that
the representatives' own queue contribution is marginal (the regime the
subsystem exists for).  Both are validated in the reference's tests:
``test_meanfield_waits_match_exact_des_within_10pct`` checks the mean hop
against the full exact DES at a K where both run, and
``test_meanfield_matches_md1_poisson`` checks the arrival-rate summation
against the analytic M/D/1 reference on Poisson arrivals.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import federated
from repro_torch.des import queueing
from repro_torch.pop.population import CompactPopulation, populations

# Tag added to the campaign seed for the representative-client draw — a
# distinct stream from cohort sampling (0x5EED) and channel fades (7919),
# same idiom as repro_torch.sim.events.
REP_STREAM_TAG = 0xAB5E


def meanfield_backhaul_hop(topology, fcfg, assign, eta,
                           totals: np.ndarray) -> np.ndarray:
    """(K,) analytic backhaul hop under per-cell arrival-rate processes.

    Each cell's jobs (``topology._backhaul_jobs`` — per client for
    edge-cloud/relay, one pre-aggregated delta per edge for edge-agg) are
    modelled as an arrival-rate process over that cell's own completion
    span; the shared queue sees the aggregate rate λ = Σ_m n_m/span_m.
    The mean wait is the analytic M/D/1 (FIFO) / PS model at (λ, s̄),
    capped at the all-at-once batch backlog — (n−1)·s̄/2 for FIFO (the
    exact mean of a simultaneous equal-service batch), (n−1)·s̄ for PS
    (every job of a simultaneous PS batch finishes together at n·s̄).
    FIFO waits ramp linearly in arrival rank (later arrivals expect
    proportionally more backlog, matching ``allocation``'s wait-aware
    model); PS waits are rank-independent (the egalitarian discipline).
    Clients whose wireless total is non-finite never reach the queue and
    get hop 0, exactly like ``HierTopology._queued_backhaul``.
    """
    totals = np.asarray(totals, float)
    arrivals, bits, job_of = topology._backhaul_jobs(fcfg, assign, eta,
                                                     totals)
    service = queueing.service_seconds(bits, topology.backhaul_bps)
    finite = np.isfinite(arrivals)
    n = int(np.count_nonzero(finite))
    hop_jobs = np.zeros(len(arrivals))
    if n:
        s_bar = float(np.mean(service[finite]))
        if n > 1 and s_bar > 0:
            # the cell each job came from (per-client jobs: the client's
            # cell; per-edge jobs: the edge itself)
            job_cell = np.zeros(len(arrivals), int)
            job_cell[job_of] = np.asarray(assign, int)
            lam, singles = 0.0, 0
            for m in np.unique(job_cell[finite]):
                sel = finite & (job_cell == m)
                nm = int(np.count_nonzero(sel))
                if nm < 2:
                    singles += nm
                    continue
                span = float(np.max(arrivals[sel]) - np.min(arrivals[sel]))
                if span > 0:
                    lam += nm / span
                else:
                    lam = np.inf  # a simultaneous burst saturates the rate
            if singles and np.isfinite(lam):
                gspan = float(np.max(arrivals[finite])
                              - np.min(arrivals[finite]))
                lam += singles / gspan if gspan > 0 else np.inf
            if topology.backhaul_model == "ps":
                mean_wait = (queueing.ps_mean_wait(lam, s_bar)
                             if np.isfinite(lam) else np.inf)
                wait = np.full(n, min(mean_wait, (n - 1) * s_bar))
            else:  # fifo
                mean_wait = (queueing.md1_mean_wait(lam, s_bar)
                             if np.isfinite(lam) else np.inf)
                mean_wait = min(mean_wait, 0.5 * (n - 1) * s_bar)
                ranks = np.empty(n)
                ranks[np.argsort(arrivals[finite],
                                 kind="stable")] = np.arange(n)
                wait = mean_wait * 2.0 * ranks / (n - 1)
            hop_jobs[finite] = wait + service[finite]
        else:
            hop_jobs[finite] = service[finite]
    hop = hop_jobs[job_of]
    hop[~np.isfinite(totals)] = 0.0
    return hop


@populations.register("meanfield")
class MeanFieldPopulation(CompactPopulation):
    """``compact`` + representative timeline + analytic queues (see the
    module docstring for the three reductions and the validity regime).

    ``window`` sizes the device batch (default: the campaign cohort);
    ``reps`` sizes the representative set the timeline and the per-cell
    allocator run on (default: the window).  ``reps ≥ K`` degenerates the
    timeline and allocation back to exact (only the analytic queue pricing
    remains).
    """

    name = "meanfield"

    def __init__(self, window: Optional[int] = None,
                 reps: Optional[int] = None):
        super().__init__(window=window)
        if reps is not None and reps < 1:
            raise ValueError(f"reps must be ≥ 1, got {reps}")
        self.reps = None if reps is None else int(reps)
        self.rep_ids: Optional[np.ndarray] = None  # bound by begin_campaign

    def params(self) -> dict:
        return {"window": self.window, "reps": self.reps}

    def begin_campaign(self, num_clients: int, cohort: int,
                       campaign_seed: int) -> None:
        super().begin_campaign(num_clients, cohort, campaign_seed)
        n_rep = self.reps if self.reps is not None else self._window
        n_rep = min(max(int(n_rep), self._window), num_clients)
        if n_rep >= num_clients:
            self.rep_ids = None  # full population: exact timeline
        else:
            # seeded, campaign-fixed representative draw — rides the same
            # O(cohort) client_sample as cohorts, on its own stream
            self.rep_ids = federated.client_sample(
                0, num_clients, n_rep, seed=campaign_seed + REP_STREAM_TAG)
            self._pool = self.rep_ids  # window fill stays inside the reps

    def timeline_clients(self) -> Optional[np.ndarray]:
        return self.rep_ids

    def queued_hop(self, topology, fcfg, assign, eta,
                   totals) -> Optional[np.ndarray]:
        return meanfield_backhaul_hop(topology, fcfg, assign, eta, totals)
