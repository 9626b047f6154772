"""Execution schedules — the 6th pluggable strategy axis (port of
``repro/des/schedules.py``: the same numpy code, so the same plans and event
order).

The campaign engine used to be hard-wired round-synchronous: every global
round waits for its slowest cohort member (or cuts it at the deadline), so
the server idles while clients compute and vice versa.  Related systems
show the synchronisation barrier is where the wall-clock goes — pipelining
client/server computation (arXiv 2504.14667) and exploiting asynchronous
client completion (FedAsync/FedBuff) both cut fine-tuning latency without
touching the learning rule.  This module makes the *execution discipline* a
first-class :class:`Schedule`, registered by name like the other five axes
(aggregators / allocators / compressors / scenarios / topologies):

  ``sync``        the round-synchronous default — replays today's campaign
                  event order through the event engine and is bit-identical
                  to the pre-schedule trajectories (tests pin this)
  ``pipelined``   GPipe-across-the-wireless-split: the client's forward of
                  microbatch i+1 overlaps the server's compute of microbatch
                  i, so each local iteration costs ``max(stage) +
                  (sum−max)/M`` instead of ``sum`` (§III decomposition via
                  ``repro_torch.parallel.pipeline``) — simulated round wall-clock
                  strictly drops whenever at least two stages are non-zero
  ``async``       no barrier at all: clients rejoin immediately on
                  completion and the server aggregates each arrival with the
                  staleness-discounted weight w ∝ D_k/(1+staleness)^β
                  (``federated.staleness_weighted``); campaign round r is
                  the r-th aggregation event
  ``semi-async``  FedBuff-style buffer-K: the server buffers arrivals and
                  aggregates once ``buffer_k`` updates are in, each
                  staleness-discounted

A schedule decides three things per campaign round — which client states
feed the aggregation (the survivor mask + ``client_ids``), at what weight
(the staleness ``weight_scale`` folded onto D_k), and what the round costs
on the simulated clock (``round_time`` + the per-event trace).  Everything
is host-side: masks and weights enter the round function through its
value-only arguments, so no schedule builds another round function
(``Experiment.trace_count`` bounds are unchanged).

The asynchronous schedules run a deterministic discrete-event timeline
(:mod:`repro_torch.des.engine`) over the whole campaign, pricing each client's
j-th run by the scenario's round-j realisation (``events.round_state`` — a
pure function of ``(RunConfig, seed, j)``), so campaigns stay pure in
``(RunConfig, seed)`` and checkpoint resume replays the identical timeline
(the same re-run-from-round-0 idiom as the ``drift`` walk).

    exp = Experiment.from_config(run_cfg, schedule="pipelined")
    exp.run(num_rounds=20, stream=stream)      # wall-clock drops vs sync

Unknown names raise ``KeyError`` listing the knowns, like every registry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from repro_torch.core import delay_model as dm
from repro_torch.core import federated
from repro_torch.des.engine import EventSim
from repro_torch.parallel import pipeline as pl
from repro_torch.registry import Registry
from repro_torch.sim import events as sim_events

schedules: Registry = Registry("schedule")


@dataclass
class RoundPlan:
    """What the schedule decided for one campaign round (host-side)."""

    round: int  # absolute global-round index (= aggregation index)
    mask: Optional[np.ndarray]  # (C,) aggregation survivors; None = all
    round_time: float  # simulated seconds this round costs the server
    client_ids: Optional[np.ndarray] = None  # override cohort (None = loop's)
    weight_scale: Optional[np.ndarray] = None  # (C,) staleness discounts on D_k
    update_scale: Optional[float] = None  # server mixing rate α on the update
    staleness: Optional[np.ndarray] = None  # (C,) versions behind, survivors
    completion: Optional[np.ndarray] = None  # (C,) per-client completion, s
    events: Optional[list] = None  # per-event timing records (dicts, in order)


class Schedule:
    """Base class: how client work and server aggregation interleave.

    All methods must be pure in their arguments — determinism in
    ``(seed, round)`` is part of the registry contract (property-tested for
    every registered name), and checkpoint resume relies on a re-planned
    schedule reproducing the interrupted timeline exactly.
    """

    name = "schedule"

    def params(self) -> dict:
        """Constructor parameters that change the discipline (doc/digest)."""
        return {}

    def planner(self, exp, *, campaign_seed: int, start: int, target: int,
                cohort: int, fixed_cohort: Optional[int],
                deadline: Optional[float], resample_channel: bool,
                reallocate: bool, realloc_search: str):
        """A per-campaign planner: ``planner.round_plan(r, ids)`` → plan.

        The default (synchronous family) planner prices each round from the
        experiment's CURRENT state — the campaign loop has already advanced
        ``exp.net/alloc/timing`` to round ``r`` when it asks.  Timeline
        schedules (async) override this and pre-simulate the whole
        campaign's event order instead.
        """
        return _PerRoundPlanner(self, exp, deadline)

    def _plan(self, exp, round_idx: int, ids: np.ndarray,
              deadline: Optional[float]) -> RoundPlan:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"{type(self).__name__}({self.name!r})"


class _PerRoundPlanner:
    """Planner for schedules that only need the current round's pricing."""

    def __init__(self, schedule: Schedule, exp, deadline: Optional[float]):
        self._schedule = schedule
        self._exp = exp
        self._deadline = deadline

    def round_plan(self, round_idx: int, ids: np.ndarray) -> RoundPlan:
        return self._schedule._plan(self._exp, round_idx, ids, self._deadline)


class _TimelinePlanner:
    """Planner for schedules that pre-simulated the campaign timeline.

    ``pricing`` maps round index → the ``events.round_state`` tuple the
    timeline already computed for that round; the campaign loop consumes it
    instead of re-pricing (under ``reallocate=True`` that would mean two
    full (16)/(17) solves per round)."""

    def __init__(self, plans: dict[int, RoundPlan], pricing: dict):
        self._plans = plans
        self.pricing = pricing

    def round_plan(self, round_idx: int, ids: np.ndarray) -> RoundPlan:
        return self._plans[round_idx]


def _mask_and_clock(completion: np.ndarray, deadline: Optional[float]
                    ) -> tuple[Optional[np.ndarray], float]:
    """The legacy straggler arithmetic on a vector of completion times —
    byte-identical to ``events.straggler_mask`` + ``round_wall_clock``."""
    mask = (None if deadline is None
            else federated.deadline_mask(completion, deadline))
    slowest = float(np.max(completion))
    return mask, (slowest if deadline is None else min(slowest, float(deadline)))


def _completion_trace(completion: np.ndarray, ids: np.ndarray,
                      round_time: float) -> list[dict]:
    """The round's event record: one completion per cohort client (popped in
    ``(time, seq)`` order by the engine) plus the server aggregation."""
    sim = EventSim()
    for pos, k in enumerate(ids):
        sim.schedule(float(completion[pos]), "complete", client=int(k))
    sim.schedule(float(round_time), "aggregate")
    return [{"t": e.time, "kind": e.kind, **e.data} for e in sim.run()]


@schedules.register("sync")
class SyncSchedule(Schedule):
    """The round-synchronous default — bit-identical to the pre-schedule
    engine.  Completion events are the §III per-client round totals; the
    survivor mask and round wall-clock derive from them with the exact
    arithmetic the legacy ``events.straggler_mask``/``round_wall_clock``
    used, so every existing campaign golden reproduces bit-for-bit."""

    name = "sync"

    def _plan(self, exp, round_idx, ids, deadline):
        completion = np.asarray(exp.timing.total, float)[ids]
        mask, round_time = _mask_and_clock(completion, deadline)
        return RoundPlan(round=round_idx, mask=mask, round_time=round_time,
                         completion=completion,
                         events=_completion_trace(completion, ids, round_time))


@schedules.register("pipelined")
class PipelinedSchedule(Schedule):
    """Microbatch-pipelined split execution (GPipe across the wireless cut).

    Each local iteration's sequential chain — client fwd → uplink → server
    fwd/bwd → client bwd — is split into ``num_microbatches`` slices so the
    client's forward of microbatch i+1 overlaps the server's compute of
    microbatch i: per-iteration cost drops from ``sum(stages)`` to
    ``max(stage) + (sum − max)/M`` (``repro_torch.parallel.pipeline``).  The §III
    stage decomposition keeps the paper's negligible-downlink convention
    (``downlink_frac=0``), so the M=1 degenerate case reproduces eq. (15)'s
    round total exactly and any M>1 strictly improves it whenever at least
    two stages are non-zero.  The fed uplink ``t_c`` (once per round) and
    any backhaul/downlink hop of a hierarchical path are outside the
    per-iteration loop and unchanged.  Aggregation semantics are untouched
    — only completion times (hence straggler masks and the round clock)
    move.
    """

    name = "pipelined"

    def __init__(self, num_microbatches: int = 4):
        if num_microbatches < 1:
            raise ValueError(
                f"num_microbatches must be ≥ 1, got {num_microbatches}")
        self.num_microbatches = int(num_microbatches)

    def params(self):
        return {"num_microbatches": self.num_microbatches}

    def pipelined_totals(self, fcfg, net, alloc, eta: float) -> np.ndarray:
        """(K,) per-client WIRELESS round completion under pipelined local
        iterations — pure in its arguments: the §III stage decomposition of
        ``(net, alloc, η)`` with the per-iteration overlap applied."""
        stages = pl.split_stage_times(fcfg, net, eta, alloc.A, alloc,
                                      downlink_frac=0.0)
        per_iter = pl.pipeline_round_time(stages, self.num_microbatches)
        V = dm.local_iters(fcfg, eta)
        return (np.asarray(alloc.t_c, float)
                + V * np.asarray(per_iter["pipelined_s"], float))

    def completion_times(self, exp) -> np.ndarray:
        """(K,) pipelined end-to-end completions at the experiment's current
        pricing.  Hierarchical hops compose on top of the PIPELINED
        wireless completions: the serial pipe is arrival-independent, but
        the queueing backhaul models (``backhaul_model="fifo"/"ps"``) see
        the pipelined arrival times — re-using the sync-arrival waits would
        mix two timelines."""
        fcfg, eta, topo = exp.fcfg, exp.eta, exp.topology
        total = self.pipelined_totals(fcfg, exp.net, exp.alloc, eta)
        if getattr(topo, "num_edges", 0) and exp.assign is not None:
            total = total + topo.backhaul_hop(fcfg, exp.assign, eta, total)
            dl = topo.downlink_hop(fcfg, exp.assign)
            if dl is not None:  # broadcast cost is arrival-independent
                total = total + np.asarray(dl, float)
        return total

    def _plan(self, exp, round_idx, ids, deadline):
        completion = self.completion_times(exp)[ids]
        mask, round_time = _mask_and_clock(completion, deadline)
        return RoundPlan(round=round_idx, mask=mask, round_time=round_time,
                         completion=completion,
                         events=_completion_trace(completion, ids, round_time))


@schedules.register("async")
class AsyncSchedule(Schedule):
    """Fully asynchronous execution: no round barrier, immediate rejoin.

    All K simulated clients compute continuously; each *valid* completion
    (within the deadline, when one is set) is an arrival at the server.
    The server aggregates every ``buffer_k`` arrivals (1 here — FedAsync;
    ``semi-async`` raises it — FedBuff) and bumps the global version;
    campaign round r is the r-th aggregation.  An arrival that started at
    version v and lands at version r carries staleness r − v; the
    discount ``1/(1+staleness)^β`` enters TWICE, because the weighted mean
    normalizes: relatively, as ``D_k``-weight scaling among the buffered
    arrivals (``federated.staleness_weighted``'s rule, pre-folded into the
    round function's value-only ``weights`` argument — only meaningful at
    ``buffer_k ≥ 2``), and absolutely, as the server mixing rate
    ``α = mean discount`` applied to the aggregated update
    (Δw ← Δw + α·h̄ — the FedAsync damping; with a single arrival a weight
    discount alone would cancel in the normalization).  A client whose run
    would exceed the deadline is cancelled at the deadline and restarts
    fresh (an explicit ``timeout`` event in the trace).

    The whole timeline is one deterministic event simulation: client k's
    j-th run lasts the §III round total of the scenario's round-j
    realisation (``events.round_state`` — pure in ``(seed, j)``), so two
    runs of the same config produce byte-identical timelines and resume
    replays exactly.  With ``server_ps=True`` the main-server GPU is an
    egalitarian processor-sharing resource: immediate rejoin keeps all K
    clients concurrently active, so each run's server-compute share
    stretches by the population factor (the exact PS fluid limit at
    constant concurrency — see ``repro_torch.des.queueing.processor_sharing``).

    The round function still steps the full population each aggregation
    (``client_ids`` = all K; the mask selects the arrivals), so the cohort
    argument does not subsample under async schedules — batch shapes stay
    fixed and ``trace_count`` bounds are unchanged.
    """

    name = "async"
    buffer_k = 1

    def __init__(self, beta: float = 0.5, buffer_k: Optional[int] = None,
                 server_ps: bool = False):
        if beta < 0:
            raise ValueError(f"staleness beta must be ≥ 0, got {beta}")
        self.beta = float(beta)
        if buffer_k is not None:
            if buffer_k < 1:
                raise ValueError(f"buffer_k must be ≥ 1, got {buffer_k}")
            self.buffer_k = int(buffer_k)
        self.server_ps = bool(server_ps)

    def params(self):
        return {"beta": self.beta, "buffer_k": self.buffer_k,
                "server_ps": self.server_ps}

    # -- per-run pricing ---------------------------------------------------
    def _duration_table(self, exp, campaign_seed, resample, reallocate,
                        realloc_search):
        """j → (K,) run durations, lazily priced and cached per round index
        (pure in ``(exp constructor state, seed, j)``).  Returns the lookup
        fn plus the raw per-round pricing tuples, which the campaign loop
        re-uses instead of re-solving (``_TimelinePlanner.pricing``)."""
        base_alloc = exp.alloc
        cache: dict[int, np.ndarray] = {}
        pricing: dict[int, tuple] = {}

        def durations(j: int) -> np.ndarray:
            if j not in cache:
                state = sim_events.round_state(
                    exp, campaign_seed, j, base_alloc=base_alloc,
                    resample=resample, reallocate=reallocate,
                    realloc_search=realloc_search)
                pricing[j] = state
                net, assign, alloc, eta, timing = state
                total = np.asarray(timing.total, float)
                K = len(total)
                if self.server_ps and K > 1:
                    # PS fluid limit at constant concurrency K: the server
                    # share (1−A)·E·log2(1/η)/f_server of eq. (10) runs at
                    # rate f_server/K, i.e. K× longer — add the (K−1)×
                    # stretch on top of the dedicated-GPU pricing
                    srv = (1.0 - float(alloc.A)) * dm.compute_time(
                        exp.fcfg, net, eta, 0.0)
                    total = total + (K - 1) * srv
                cache[j] = total
            return cache[j]

        return durations, pricing

    # -- the timeline ------------------------------------------------------
    def planner(self, exp, *, campaign_seed, start, target, cohort,
                fixed_cohort, deadline, resample_channel, reallocate,
                realloc_search):
        K = exp.fcfg.num_clients
        if fixed_cohort is not None and fixed_cohort != K:
            raise ValueError(
                f"schedule {self.name!r} runs the full population (K={K}) "
                f"through every aggregation; batches= has leading axis "
                f"{fixed_cohort} — pass stream=/batches_fn= or K-sized "
                f"batches")
        # the population model (9th axis) may restrict the timeline to its
        # representative clients (meanfield): only those launch/complete,
        # so the event heap holds O(C) entries instead of O(K).  ``exact``
        # and ``compact`` return None — the full population runs.
        pop = getattr(exp, "population", None)
        active = pop.timeline_clients() if pop is not None else None
        members = (np.arange(K) if active is None
                   else np.asarray(active, int))
        if self.buffer_k > len(members):
            # the pending buffer is keyed by client (a recompletion
            # supersedes its own stale update), so it can never hold more
            # than len(members) distinct arrivals — the timeline would
            # spin forever
            raise ValueError(
                f"schedule {self.name!r} buffer_k={self.buffer_k} can never "
                f"fill with only {len(members)} timeline clients "
                f"(num_clients={K}; the buffer holds at most one pending "
                f"update per client)")
        durations, pricing = self._duration_table(exp, campaign_seed,
                                                  resample_channel,
                                                  reallocate, realloc_search)
        sim = EventSim()
        plans: dict[int, RoundPlan] = {}
        state = {"version": 0, "last_agg": 0.0, "round_events": [],
                 "since_agg": 0}
        start_version = np.zeros(K, int)
        run_idx = np.zeros(K, int)
        # pending updates keyed by client: a client that completes AGAIN
        # before the buffer fills supersedes its own stale pending update
        # (one round-function slot per client), so an aggregation always
        # carries ``buffer_k`` DISTINCT arrivals
        buffer: dict[int, int] = {}  # client -> staleness of pending update

        def launch(sim, k: int) -> None:
            d = float(durations(run_idx[k])[k])
            run_idx[k] += 1
            start_version[k] = state["version"]
            if deadline is not None and not d <= deadline:
                sim.after(float(deadline), "timeout", client=k)
            else:
                sim.after(d, "complete", client=k)

        def handler(sim, ev) -> None:
            k = ev.data.get("client")
            # stall guard: with every handler path relaunching the client,
            # the heap never drains — a deadline that cancels EVERY run
            # would otherwise spin timeouts until the generic event budget
            state["since_agg"] += 1
            if state["since_agg"] > 50 * K:
                raise RuntimeError(
                    f"schedule {self.name!r} produced no aggregation in "
                    f"{state['since_agg']} events (at round "
                    f"{state['version']} of {target}) — the deadline "
                    f"({deadline}) cancels every run before completion")
            if ev.kind == "timeout":
                state["round_events"].append(
                    {"t": ev.time, "kind": "timeout", "client": k})
                launch(sim, k)
                return
            if ev.kind != "complete":
                return
            r = state["version"]
            stale = r - start_version[k]
            state["round_events"].append(
                {"t": ev.time, "kind": "complete", "client": k,
                 "staleness": int(stale)})
            buffer[k] = int(stale)
            if len(buffer) >= self.buffer_k:
                mask = np.zeros(K, np.float32)
                staleness = np.zeros(K, float)
                scale = np.ones(K, float)
                for c, s in buffer.items():
                    mask[c] = 1.0
                    staleness[c] = s
                    scale[c] = float(federated.staleness_discount(s, self.beta))
                buffer.clear()
                state["round_events"].append(
                    {"t": ev.time, "kind": "aggregate", "round": r,
                     "arrivals": int(mask.sum())})
                arrived = mask > 0
                plans[r] = RoundPlan(
                    round=r, mask=mask,
                    round_time=float(ev.time - state["last_agg"]),
                    client_ids=np.arange(K), weight_scale=scale,
                    # server mixing rate α: the mean staleness discount of
                    # the buffered arrivals — the ABSOLUTE damping a
                    # normalized weighted mean cannot express (with one
                    # arrival any per-client discount cancels)
                    update_scale=float(np.mean(scale[arrived])),
                    staleness=staleness,
                    events=state["round_events"])
                state["last_agg"] = ev.time
                state["round_events"] = []
                state["since_agg"] = 0
                state["version"] = r + 1
                if state["version"] >= target:
                    sim.stop()
            launch(sim, k)

        for k in members:
            launch(sim, int(k))
        sim.run(handler, max_events=max(10_000, 1_000 * (target + 1) * K))
        return _TimelinePlanner(plans, pricing)


@schedules.register("semi-async")
class SemiAsyncSchedule(AsyncSchedule):
    """FedBuff-style buffered asynchrony: aggregate every ``buffer_k``
    arrivals instead of every single one.  Same timeline machinery, same
    staleness discount — the buffer trades aggregation frequency (server
    load, version churn) against per-update freshness."""

    name = "semi-async"
    buffer_k = 4


def get_schedule(spec: Union[str, Schedule]) -> Schedule:
    """Resolve a schedule name or pass an instance through.

    ``get_schedule("pipelined")`` → the registered default instance;
    ``get_schedule(PipelinedSchedule(num_microbatches=8))`` → the object
    itself.  Unknown names raise ``KeyError`` listing the registered names.
    """
    if isinstance(spec, Schedule):
        return spec
    if isinstance(spec, type) and issubclass(spec, Schedule):
        return spec()
    cls = schedules.get(spec)
    return cls()
