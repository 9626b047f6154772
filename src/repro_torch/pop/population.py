"""Client-population models — the 9th pluggable strategy axis (port of
``repro/pop/population.py``).

Every execution schedule used to push the FULL simulated population through
the round function each aggregation (the async family literally sets
``client_ids = arange(K)`` and lets the mask pick the arrivals), and the
discrete-event timeline launched all K clients.  Both are O(K) per round —
fine at the paper's K=8–50, impossible at the ROADMAP's 10⁴–10⁶ target.
This module makes the *population model* a first-class :class:`Population`,
registered by name like the other eight axes (aggregators / allocators /
compressors / scenarios / topologies / schedules / local_algos / workloads):

  ``exact``      every client is simulated and trained individually — the
                 default, bit-identical to the pre-population engine (every
                 campaign golden pins this path)
  ``compact``    compacted cohorts: each aggregation's arrivals plus a
                 fixed-size in-flight window are gathered into a dense
                 ``(C, …)`` batch, so the round function always sees
                 shape ``(C, …)`` and per-round device FLOPs/memory stop
                 scaling with K.  The gather/scatter of per-client algorithm
                 state rides the round function's existing ``algo_ids``
                 ``x[ids]`` / ``index_copy`` mechanism (SCAFFOLD's
                 variates), and global ``D_k`` weights ride ``client_ids``
                 (the reference also C-shards the window batch over its
                 TPU mesh; on one card there is nothing to shard).  The
                 timeline and queue pricing stay exact (still O(K) host
                 work per round).
  ``meanfield``  ``compact`` plus a mean-field DES: only a seeded set of C
                 *representative* clients runs in the discrete-event
                 timeline, the other K−C clients become per-cell
                 arrival-rate processes feeding the FIFO/PS backhaul queues
                 analytically, and per-cell rate allocation solves on the
                 representatives with population multiplicities
                 (``repro_torch.pop.meanfield`` — validity regime and validation
                 tests in its module docstring).  Campaign cost becomes
                 O(cohort) end to end.

A population owns five hooks, every one a no-op on ``exact`` so the default
path stays byte-for-byte untouched:

  * ``begin_campaign(K, cohort, seed)`` — bind per-campaign state (window
    size, representative set); re-bound on every ``run()`` so campaigns
    stay pure in ``(RunConfig, seed)`` and resume replays identically;
  * ``compact_plan(plan, ids, round)`` — compact a K-sized async
    :class:`~repro_torch.des.schedules.RoundPlan` onto the fixed window;
  * ``timeline_clients()`` — restrict the event timeline's launch set;
  * ``queued_hop(topology, …)`` — replace the exact queue simulation with
    an analytic arrival-rate model (``meanfield`` only);
  * ``device_batch(batches)`` — place the ``(C, …)`` window batch (the
    reference shards it over its mesh's batch axis; on one card, the
    identity).

The population name + params join the checkpoint identity guard (the same
family as scenario/topology/schedule digests): resume refuses a
population-name or window-size mismatch.

    exp = Experiment.from_config(run_cfg, schedule="async",
                                 population="compact")
    exp.run(num_rounds=20, stream=stream, cohort=8)   # (8, …) batches

Unknown names raise ``KeyError`` listing the knowns, like every registry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from repro_torch.registry import Registry

populations: Registry = Registry("population")


class Population:
    """Base class: how the K simulated clients map onto simulated work.

    All methods must be pure in their arguments plus the state bound by
    ``begin_campaign`` — determinism in ``(seed, round)`` is part of the
    registry contract, and checkpoint resume relies on a re-bound
    population reproducing the interrupted campaign's windows exactly.
    """

    name = "population"

    def params(self) -> dict:
        """Constructor parameters that change the model (checkpoint guard)."""
        return {}

    def begin_campaign(self, num_clients: int, cohort: int,
                       campaign_seed: int) -> None:
        """Bind per-campaign state; called at the top of every ``run()``."""

    def compact_plan(self, plan, ids: np.ndarray,
                     round_idx: int) -> tuple:
        """Compact one round's plan + cohort ids; identity for ``exact``."""
        return plan, ids

    def timeline_clients(self) -> Optional[np.ndarray]:
        """Clients the event timeline launches; None = the full population."""
        return None

    def queued_hop(self, topology, fcfg, assign, eta,
                   totals) -> Optional[np.ndarray]:
        """(K,) analytic backhaul hop, or None to run the exact queue sim."""
        return None

    def device_batch(self, batches):
        """Place/shard the stacked per-round batch; identity for ``exact``."""
        return batches

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"{type(self).__name__}({self.name!r})"


@populations.register("exact")
class ExactPopulation(Population):
    """Every client simulated and trained individually — the default,
    bit-identical to the pre-population engine (every hook is the
    identity, so nothing downstream can tell this axis exists)."""

    name = "exact"


@populations.register("compact")
class CompactPopulation(Population):
    """Compacted cohorts: O(cohort) device cost under async schedules.

    Each aggregation gathers its arrivals plus enough in-flight clients to
    fill a FIXED-size window of ``window`` clients (default: the campaign
    cohort) into a dense ``(C, …)`` batch.  Non-arrival window members ride
    along fully masked (a masked client contributes exactly +0.0 to the
    weighted-mean sums), so the aggregation equals the exact K-sized round
    up to float summation order — and the round function always sees
    shape ``(C, …)``: ``trace_count`` bounds are unchanged.  The window
    fill rotates deterministically
    through the population keyed by round index, so per-client algorithm
    state (SCAFFOLD variates, gathered/scattered via ``algo_ids``)
    keeps refreshing across the whole population.

    Sync-family plans (``plan.client_ids is None``) are already
    cohort-sized and pass through untouched; a window of at least the full
    population degenerates to ``exact``.
    """

    name = "compact"

    def __init__(self, window: Optional[int] = None):
        if window is not None and window < 1:
            raise ValueError(f"window must be ≥ 1, got {window}")
        self.window = None if window is None else int(window)
        self._window: Optional[int] = None  # bound by begin_campaign
        self._pool: Optional[np.ndarray] = None

    def params(self) -> dict:
        return {"window": self.window}

    def begin_campaign(self, num_clients: int, cohort: int,
                       campaign_seed: int) -> None:
        self._window = min(self.window if self.window is not None else cohort,
                           num_clients)
        self._pool = np.arange(num_clients)

    def compact_plan(self, plan, ids: np.ndarray, round_idx: int) -> tuple:
        if plan.client_ids is None or plan.mask is None:
            return plan, ids  # sync family: already cohort-sized
        K = len(plan.client_ids)
        if self._window is None or self._window >= K:
            return plan, ids  # unbound, or window covers the population
        pool = self._pool if self._pool is not None else np.arange(K)
        want = min(self._window, len(pool))
        arrivals = np.where(np.asarray(plan.mask) > 0)[0]
        if len(arrivals) > want:
            raise ValueError(
                f"population {self.name!r} window={want} cannot hold the "
                f"{len(arrivals)} arrivals of round {round_idx} — raise "
                f"window= (or cohort=) to at least the schedule's buffer_k")
        # deterministic rotating fill: arrivals first, then pool members
        # starting at a round-keyed offset, so the fixed-size window sweeps
        # the whole population across rounds (pure in round_idx — resume
        # replays the identical windows)
        sel = set(int(a) for a in arrivals)
        start = (round_idx * want) % len(pool)
        i = 0
        while len(sel) < want and i < len(pool):
            sel.add(int(pool[(start + i) % len(pool)]))
            i += 1
        window = np.sort(np.fromiter(sel, np.int64, count=len(sel)))
        take = lambda a: None if a is None else np.asarray(a)[window]  # noqa: E731
        plan = dataclasses.replace(
            plan, client_ids=window, mask=take(plan.mask),
            weight_scale=take(plan.weight_scale),
            staleness=take(plan.staleness),
            completion=take(plan.completion))
        return plan, window

    # device_batch: the reference C-shards the window batch over its mesh's
    # "batch" axis; one card holds the whole batch, so the base class's
    # identity is the port's placement


def get_population(spec: Union[str, Population]) -> Population:
    """Resolve a population name or pass an instance through.

    ``get_population("compact")`` → the registered default instance;
    ``get_population(CompactPopulation(window=16))`` → the object itself.
    Unknown names raise ``KeyError`` listing the registered names.
    """
    if isinstance(spec, Population):
        return spec
    if isinstance(spec, type) and issubclass(spec, Population):
        return spec()
    cls = populations.get(spec)
    return cls()
