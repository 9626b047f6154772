"""Multi-round campaign engine (port of ``repro/sim/campaign.py``).

Drives an :class:`repro_torch.api.Experiment` through repeated global rounds
under *time-varying* wireless scenarios: per-round channel evolution delegated
to the experiment's :class:`repro_torch.sim.scenario.Scenario` (block fading, fixed
geometry, mobility, device tiers, outage bursts), optional per-round joint
allocator re-solves, elastic cohorts via ``federated.client_sample`` and
deadline-based straggler masks derived from each round's simulated
:class:`~repro_torch.core.fedsllm.RoundTiming`.  The mask is threaded into
the round function's ``mask`` argument, so a fixed-η campaign reuses ONE
round function, and a joint-η campaign (``reallocate=True``) builds at most
one per η bucket (``Experiment.trace_count``).

A campaign is a pure function of ``(RunConfig, seed)``: channel draws,
cohorts and data are all keyed by the absolute round index, so two runs of
the same config are bit-identical and a checkpoint-resumed campaign replays
exactly the rounds an uninterrupted one would have run.

    res = exp.run(num_rounds=20, stream=stream, cohort=8,
                  deadline=5.0, resample_channel=True)
    res.history("loss_round_start"), res.total_time, res.records[3].mask
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, TYPE_CHECKING

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import fedsllm
from repro_torch.core.fedsllm import FedsLLMState, RoundTiming
from repro_torch.core.resource_alloc import Allocation
from repro_torch.sim import events
from repro_torch.tree import tree_leaves, tree_stack

if TYPE_CHECKING:  # pragma: no cover — avoid an api import cycle
    from repro_torch.api.experiment import Experiment


@dataclass
class RoundRecord:
    """Everything one campaign round produced (host-side, reporting-ready)."""

    round: int  # absolute global-round index n
    client_ids: np.ndarray  # (C,) simulated users trained this round
    mask: Optional[np.ndarray]  # (C,) deadline survivors; None = no deadline
    metrics: dict[str, float]  # round metrics, device-synced to floats
    alloc: Allocation  # the allocation this round was priced under
    timing: RoundTiming  # (K,) per-user simulated delays this round
    round_time: float  # simulated seconds this round cost the server
    cumulative_time: float  # simulated campaign wall-clock through this round
    eta: float = 0.0  # training η this round ran at (varies under reallocate)
    # per-event timing records from the execution schedule (dicts in
    # (time, seq) order: complete / timeout / aggregate), and the staleness
    # each surviving update carried (async schedules; None under sync)
    events: Optional[list] = None
    staleness: Optional[np.ndarray] = None
    # (C,) per-client completion times AS THE SCHEDULE PRICED THEM — under
    # ``pipelined`` these differ from ``timing`` (which keeps the §III
    # sequential pricing); the recorded mask/round_time derive from these
    completion: Optional[np.ndarray] = None

    @property
    def cohort_size(self) -> int:
        return len(self.client_ids)

    @property
    def survivors(self) -> int:
        return self.cohort_size if self.mask is None else int(np.sum(self.mask > 0))

    @property
    def stragglers(self) -> int:
        return self.cohort_size - self.survivors


@dataclass
class CampaignResult:
    """A finished campaign: per-round history + final state + why it stopped."""

    records: list[RoundRecord]
    state: FedsLLMState
    total_time: float  # simulated wireless seconds, whole campaign
    rounds_lemma1: int  # Lemma 1 budget a/(1-η) at the training η
    # "num_rounds" | "lemma1" | "checkpoint" (restore already covered the
    # requested rounds — records is then empty)
    stopped_by: str
    scenario: str = "blockfade"  # channel-dynamics family the rounds ran under
    topology: str = "star"  # network graph the rounds ran over
    schedule: str = "sync"  # execution discipline the rounds ran with
    population: str = "exact"  # client-population model the rounds ran with

    @property
    def num_rounds(self) -> int:
        return len(self.records)

    def history(self, metric: str) -> np.ndarray:
        """One metric across rounds, e.g. ``history("loss_round_start")``."""
        return np.asarray([r.metrics[metric] for r in self.records])

    @property
    def straggler_rate(self) -> float:
        """Fraction of cohort slots lost to the deadline over the campaign."""
        slots = sum(r.cohort_size for r in self.records)
        return sum(r.stragglers for r in self.records) / max(slots, 1)


def stream_batcher(stream, num_clients: int) -> Callable[[int, np.ndarray], Any]:
    """Per-round batches for a cohort drawn from ``num_clients`` users.

    Client ``k`` reads its own deterministic position ``r·K + k`` of the
    stream — identical to ``data.tokens.client_batches`` when the cohort is
    the full population, and stable under elastic sampling (a client's data
    does not depend on who else was sampled).
    """

    def fn(round_idx: int, client_ids: np.ndarray):
        return tree_stack([stream.batch_at(round_idx * num_clients + int(k))
                           for k in client_ids])

    return fn


def run_campaign(exp: "Experiment", num_rounds: Optional[int] = None, *,
                 stream=None, batches=None,
                 batches_fn: Optional[Callable[[int, np.ndarray], Any]] = None,
                 cohort: Optional[int] = None,
                 resample_channel: bool = True, reallocate: bool = False,
                 realloc_search: Optional[str] = "warm",
                 deadline: Optional[float] = None,
                 stop_at_lemma1: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, resume: bool = False,
                 campaign_seed: Optional[int] = None,
                 on_round: Optional[Callable[[RoundRecord], None]] = None,
                 ) -> CampaignResult:
    """Run a multi-round campaign on ``exp`` (see ``Experiment.run``).

    Data source — exactly one of:
      ``batches_fn(round_idx, client_ids) -> stacked pytree``  (full control)
      ``stream``   a ``TokenStream``; each client reads its own positions
      ``batches``  one fixed stacked pytree reused every round (cohort is
                   then pinned to its leading axis — no elastic sampling)

    Scenario axes:
      ``resample_channel``  fresh §IV network realisation per round, drawn by
          the experiment's *scenario* (``exp.scenario``, see
          ``repro_torch.sim.scenario``) keyed by ``(campaign_seed, round)`` — what
          persists between rounds (geometry, device classes, mobility) is the
          scenario's call.  With ``reallocate=False`` the stale allocation is
          re-priced under the new gains (:func:`events.retime_allocation`);
          with ``reallocate=True`` the experiment's allocator strategy
          re-solves problems (16)/(17) *jointly* every round — per edge cell
          under a hierarchical topology: the solved η* is adopted (quantized
          to the ``fcfg.eta_bucket`` grid via ``Experiment.set_eta``), so
          bandwidth, split AND the Lemma 1/2 schedule all track the channel.
          ``realloc_search`` sets the per-round η-sweep mode; the default
          ``"warm"`` sweeps a ±5-step window around the constructor's solved
          η* — ~10× cheaper and, per the reference's cross-scenario audit,
          optimal to <1e-6 of the full sweep (pass ``None`` to fall back to
          the experiment's ``eta_search``).
      ``cohort``    clients trained per round (< K ⇒ elastic subsampling via
          ``federated.client_sample``); default: the full population.
      ``deadline``  simulated seconds; cohort members whose round delay
          exceeds it are masked out of aggregation (``deadline_mask``).

    Stopping & durability:
      ``num_rounds`` is the campaign's ABSOLUTE length: rounds run from the
          state's current global round counter up to ``num_rounds``, so
          ``run(5)`` then ``run(10)`` trains rounds 0–4 then 5–9 (a second
          ``run(5)`` is a no-op, not a replay of the same scenario).
      ``stop_at_lemma1``  cap rounds at Lemma 1's ⌈a/(1−η)⌉ budget (priced
          at the campaign's starting η).
      ``checkpoint_dir``/``checkpoint_every``  periodic + final state saves;
          ``resume=True`` restores the newest checkpoint and replays the
          remaining rounds bit-identically (everything is round-indexed).
          Non-campaign checkpoints, and checkpoints from a different
          campaign — seed, η, allocator, scenario name, large-scale-state
          digest, topology name, attachment digest, execution-schedule,
          local-algorithm, workload or population mismatch — are refused.  Stateful
          local algorithms (scaffold) checkpoint their control variates
          with the model, so resume is bit-identical there too. The
          restored tensors go to the device of the experiment's state.

    Execution schedule (``exp.schedule``, the 6th axis): ``sync`` (default)
    keeps every semantics above bit-identical; ``pipelined`` re-times
    completions with microbatch overlap (masks/clock follow); ``async`` /
    ``semi-async`` replace the round barrier with a deterministic event
    timeline — round r is the r-th server aggregation, the full population
    rides through the round function and the mask/staleness weights select
    the arrivals (``repro_torch.des.schedules``).  Per-event timing records land
    on ``RoundRecord.events``.
    """
    fcfg = exp.fcfg
    K = fcfg.num_clients
    campaign_seed = exp.seed if campaign_seed is None else campaign_seed
    scenario = exp.scenario

    # --- data source ------------------------------------------------------
    provided = [x is not None for x in (batches_fn, stream, batches)]
    if sum(provided) != 1:
        raise ValueError("provide exactly one of batches_fn= / stream= / batches=")
    fixed_cohort = None
    if batches is not None:
        fixed_cohort = tree_leaves(batches)[0].shape[0]
        batches_fn = lambda r, ids: batches  # noqa: E731
    elif stream is not None:
        # the experiment's workload (7th-axis data heterogeneity) decides
        # what each client reads from the stream; ``iid`` is bit-identical
        # to the legacy stream_batcher
        batches_fn = exp.workload.batcher(stream, K)
    if stream is None and exp.workload.name != "iid":
        raise ValueError(
            f"workload {exp.workload.name!r} shapes per-client stream reads: "
            f"pass stream= (batches=/batches_fn= bypass the workload)")

    if cohort is None:
        cohort = K if fixed_cohort is None else fixed_cohort
    if fixed_cohort is not None and cohort != fixed_cohort:
        raise ValueError(f"cohort={cohort} != leading axis {fixed_cohort} of batches=")
    if not 1 <= cohort <= K:
        raise ValueError(f"cohort={cohort} must be in [1, num_clients={K}]")
    if reallocate and not resample_channel:
        raise ValueError("reallocate=True requires resample_channel=True "
                         "(re-solving the frozen channel draw is a no-op)")

    # --- stopping rule ----------------------------------------------------
    rounds_lemma1 = fedsllm.global_round_count(fcfg, exp.eta)
    if num_rounds is None and not stop_at_lemma1:
        raise ValueError("give num_rounds= and/or stop_at_lemma1=True")
    if stop_at_lemma1 and (num_rounds is None or rounds_lemma1 <= num_rounds):
        target, stopped_by = rounds_lemma1, "lemma1"
    else:
        target, stopped_by = num_rounds, "num_rounds"

    # --- checkpoint / resume ---------------------------------------------
    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    # continue the simulated wall-clock across consecutive run() calls on
    # the same Experiment (a checkpoint restore overrides it below)
    cumulative = float(getattr(exp, "campaign_time", 0.0))
    if resume and ckpt is not None:
        got = ckpt.restore_or_none(device=exp.state.round.device)
        if got is not None:
            state, meta = got
            # a checkpoint from a different campaign (or not from a campaign
            # at all) would silently splice incompatible runs — refuse
            if "round" not in meta:
                raise ValueError(
                    f"checkpoint in {checkpoint_dir!r} is not a campaign "
                    f"checkpoint (no 'round' metadata — e.g. a standard-"
                    f"training save); refusing to resume from it")
            identity = [("campaign_seed", campaign_seed),
                        ("allocator", exp.allocator_name),
                        ("scenario", scenario.name),
                        ("ls_digest", scenario.digest(fcfg, campaign_seed)),
                        ("topology", exp.topology.name),
                        ("topo_digest", exp.topology.digest(fcfg, scenario,
                                                            campaign_seed)),
                        ("schedule", exp.schedule.name),
                        # params change the timeline (β, buffer_k, M) the
                        # same way scenario/topology params change theirs
                        ("schedule_params",
                         repr(sorted(exp.schedule.params().items()))),
                        # the local algorithm + workload change the
                        # trajectory (and scaffold's checkpointed variates)
                        # the same way schedule params change the timeline
                        ("local_algo", exp.local_algo.name),
                        ("local_algo_params",
                         repr(sorted(exp.local_algo.params().items()))),
                        ("workload", exp.workload.name),
                        ("workload_params",
                         repr(sorted(exp.workload.params().items()))),
                        # the population model changes which clients ride
                        # each round's window (compact/meanfield) — a name
                        # or window/reps mismatch is a different campaign
                        ("population", exp.population.name),
                        ("population_params",
                         repr(sorted(exp.population.params().items()))),
                        ("reallocate", reallocate)]
            if not (reallocate and meta.get("reallocate")):
                # under joint reallocation η is derived per-round state, not
                # campaign identity — every resumed round re-solves it
                identity.append(("eta", exp.eta))
            for field, current in identity:
                if field in meta and meta[field] != current:
                    raise ValueError(
                        f"checkpoint in {checkpoint_dir!r} is from a "
                        f"different campaign: {field}={meta[field]!r} vs "
                        f"this run's {current!r}")
            # stateful local algorithms checkpoint their variates alongside
            # the model ({"model": ..., "algo_state": ...}); legacy saves
            # are the bare model pytree
            if isinstance(state, dict) and "model" in state:
                exp.state = state["model"]
                if exp.local_algo.stateful:
                    exp.algo_state = state["algo_state"]
            else:
                exp.state = state
            cumulative = float(meta.get("cumulative_time", 0.0))
            if int(meta["round"]) >= target:
                stopped_by = "checkpoint"  # restore already covers the ask

    # rounds are ABSOLUTE indices: the campaign picks up at the state's
    # global round counter, so a second run() (or a run() after manual
    # run_round calls) continues the scenario instead of silently replaying
    # round 0's channel draws, cohorts and batches against advanced state
    start = min(int(exp.state.round.item()), target)

    base_alloc = exp.alloc  # the last *solved* allocation (retiming input)
    # the population model (9th axis) binds its per-campaign state BEFORE
    # the planner runs: the async timeline asks it which clients to launch
    # (meanfield representatives) and the loop below asks it to compact
    # each round's plan onto the fixed window; re-binding on every run()
    # keeps campaigns pure in (RunConfig, seed) and resume-replayable.
    # ``exact`` binds nothing and every hook is the identity.
    pop = exp.population
    pop.begin_campaign(K, cohort, campaign_seed)
    # the execution schedule (6th axis) decides which client states feed
    # each aggregation, at what staleness weight, and what the round costs
    # on the simulated clock; ``sync`` replays the legacy event order
    # bit-identically, the async family pre-simulates the whole timeline
    search = exp._eta_search if realloc_search is None else realloc_search
    planner = exp.schedule.planner(
        exp, campaign_seed=campaign_seed, start=start, target=target,
        cohort=cohort, fixed_cohort=fixed_cohort, deadline=deadline,
        resample_channel=resample_channel, reallocate=reallocate,
        realloc_search=search)
    records: list[RoundRecord] = []
    for r in range(start, target):
        # (a) per-round scenario: channel evolution + re-attachment +
        # allocation + timing (``events.round_state`` — under
        # reallocate=True problems (16)/(17) re-solve jointly on this
        # round's realisation, per edge cell under a hierarchical topology,
        # and the solved η* is adopted quantized onto the η-bucket grid so
        # the Lemma 1/2 schedule tracks the channel without recompiling)
        if resample_channel:
            # timeline planners (async) already priced every round while
            # simulating run durations — reuse instead of re-solving
            priced = getattr(planner, "pricing", {}).get(r)
            net, assign, alloc, _, timing = (
                priced if priced is not None else events.round_state(
                    exp, campaign_seed, r, base_alloc=base_alloc,
                    reallocate=reallocate, realloc_search=search))
            exp.net, exp.assign, exp.alloc = net, assign, alloc
            if reallocate:
                base_alloc = alloc
                exp.set_eta(alloc.eta)
            exp.timing = timing

        # (b) elastic cohort + (c) schedule: completion events → straggler
        # mask, staleness weights and the round's simulated wall-clock
        ids = (np.arange(cohort) if fixed_cohort is not None
               else events.cohort_ids(r, K, cohort, seed=campaign_seed))
        plan = planner.round_plan(r, ids)
        if plan.client_ids is not None:  # async family: full population
            ids = plan.client_ids
        # population compaction: gather the arrivals + in-flight window of
        # a K-sized async plan onto the fixed (C,) window (identity under
        # ``exact`` and for sync-family plans)
        plan, ids = pop.compact_plan(plan, ids, r)
        mask_np = plan.mask
        mask = None if mask_np is None else torch.as_tensor(mask_np)
        round_time = plan.round_time

        # (d) train the round through the round function of this η
        res = exp.run_round(pop.device_batch(batches_fn(r, ids)),
                            mask=mask, client_ids=ids,
                            weight_scale=plan.weight_scale,
                            update_scale=plan.update_scale)

        cumulative += round_time
        rec = RoundRecord(
            round=r, client_ids=np.asarray(ids), mask=mask_np,
            metrics={k: float(v) for k, v in res.metrics.items()},
            alloc=exp.alloc, timing=exp.timing,
            round_time=round_time, cumulative_time=cumulative, eta=exp.eta,
            events=plan.events, staleness=plan.staleness,
            completion=plan.completion)
        records.append(rec)
        if on_round is not None:
            on_round(rec)

        if ckpt is not None and checkpoint_every and (r + 1) % checkpoint_every == 0:
            _save(ckpt, exp, r + 1, cumulative, campaign_seed, reallocate)

    if ckpt is not None and target > start:
        saved_on_loop = checkpoint_every and target % checkpoint_every == 0
        if not saved_on_loop:
            _save(ckpt, exp, target, cumulative, campaign_seed, reallocate)

    exp.campaign_time = cumulative
    return CampaignResult(records=records, state=exp.state,
                          total_time=cumulative, rounds_lemma1=rounds_lemma1,
                          stopped_by=stopped_by, scenario=scenario.name,
                          topology=exp.topology.name,
                          schedule=exp.schedule.name,
                          population=exp.population.name)


def _save(ckpt: Checkpointer, exp: "Experiment", rounds_done: int,
          cumulative: float, campaign_seed: int, reallocate: bool) -> None:
    # stateful local algorithms (scaffold) must resume with the exact
    # variates the interrupted campaign carried, so they ride the payload
    payload = (exp.state if exp.algo_state is None
               else {"model": exp.state, "algo_state": exp.algo_state})
    ckpt.save(rounds_done, payload,
              {"round": rounds_done, "cumulative_time": cumulative,
               "campaign_seed": campaign_seed, "eta": exp.eta,
               "allocator": exp.allocator_name,
               "scenario": exp.scenario.name,
               "ls_digest": exp.scenario.digest(exp.fcfg, campaign_seed),
               "topology": exp.topology.name,
               "topo_digest": exp.topology.digest(exp.fcfg, exp.scenario,
                                                  campaign_seed),
               "schedule": exp.schedule.name,
               "schedule_params": repr(sorted(exp.schedule.params().items())),
               "local_algo": exp.local_algo.name,
               "local_algo_params": repr(sorted(exp.local_algo.params().items())),
               "workload": exp.workload.name,
               "workload_params": repr(sorted(exp.workload.params().items())),
               "population": exp.population.name,
               "population_params":
                   repr(sorted(exp.population.params().items())),
               "reallocate": reallocate})
