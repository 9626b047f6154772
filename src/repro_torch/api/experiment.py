"""`Experiment` — the one config-driven entry point for FedsLLM runs (port of
``repro/api/experiment.py``, with the same call shapes).

Wires together, from a single frozen ``RunConfig``, the model + LoRA init,
the split cut, the Algorithm-1+2 round function, the §IV wireless channel
realisation, the delay-minimisation allocator, and the simulated round
timing. Strategy axes are pluggable by name through the registries in this
package (``aggregators`` / ``allocators`` / ``compressors``) and beside it.

    exp = Experiment.from_config(run_cfg, allocator="proposed")   # device="cuda"
    res = exp.run(num_rounds=20, stream=stream, cohort=8, deadline=5.0)
    res.history("loss_round_start"), res.total_time

Single rounds remain first-class (``run_round``); ``run`` drives the
``repro_torch.sim`` campaign engine — time-varying channels, elastic
cohorts, deadline stragglers — over the same round function.

The model lives on ``device``, the card unless the caller names another
(the tests pass ``device="cpu"``); everything else is host-side numpy, bit
for bit the reference's. The reference jit-compiles one round function per
η bucket; the port builds one (``build_round_fn``) per bucket and counts the
builds in ``trace_count``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.api.aggregators import aggregators
from repro_torch.api.allocators import allocators
from repro_torch.api.compressors import Compressor, get_compressor
from repro_torch.config import FedsLLMConfig, LoRAConfig, ModelConfig, RunConfig
from repro_torch.core import delay_model as dm
from repro_torch.core import fedsllm
from repro_torch.core.fedsllm import FedsLLMState, RoundTiming
from repro_torch.core.resource_alloc import Allocation, quantize_eta
from repro_torch.des.schedules import Schedule, get_schedule
from repro_torch.device import resolve_device
from repro_torch.fl.local_algos import LocalAlgo, get_local_algo
from repro_torch.fl.workloads import Workload, get_workload
from repro_torch.net.topology import Topology, get_topology
from repro_torch.pop import Population, get_population
from repro_torch.tree import tree_leaves


@dataclass
class RoundResult:
    """Everything one global round produces: new state, training metrics and
    the simulated wireless wall-clock the round costs under the allocation."""

    state: FedsLLMState
    metrics: dict[str, Any]
    timing: RoundTiming

    @property
    def wall_clock(self) -> float:
        """Simulated per-round wireless wall-clock (slowest client), seconds."""
        return float(np.max(self.timing.total))


class Experiment:
    """A fully-wired FedsLLM experiment (Algorithms 1+2 + problems (16)/(17)).

    Build with :meth:`from_config`; drive with :meth:`run_round`.  The
    instance owns the mutable training state; ``run_round`` advances it and
    returns the :class:`RoundResult` (the returned state is also the new
    ``exp.state``).
    """

    def __init__(self, cfg: ModelConfig, fcfg: FedsLLMConfig, *,
                 cut: Optional[int] = None, eta: Optional[float] = None,
                 aggregator: str = "weighted", allocator: str = "proposed",
                 compressor: str = "none", compressor_kw: Optional[dict] = None,
                 scenario: Union[str, "Scenario"] = "blockfade",
                 topology: Union[str, Topology] = "star",
                 schedule: Union[str, Schedule] = "sync",
                 local_algo: Union[str, LocalAlgo] = "gd",
                 workload: Union[str, Workload] = "iid",
                 population: Union[str, Population] = "exact",
                 seed: int = 0, remat: bool = False, dp_clip: float = 0.0,
                 dp_noise: float = 0.0, eta_search: str = "coarse",
                 lora_rank: int = 8, key: Optional[torch.Generator] = None,
                 net: Optional[dm.Network] = None,
                 alloc: Optional[Allocation] = None, device="cuda"):
        from repro_torch.sim.scenario import get_scenario

        self.device = resolve_device(device)  # before the allocator's solve: fail fast
        if cfg.lora is None:
            cfg = cfg.replace(lora=LoRAConfig(rank=lora_rank))
        self.cfg = cfg
        self.cut = (max(1, int(round(fcfg.split_ratio_min * cfg.num_groups)))
                    if cut is None else cut)

        # --- strategy lookups (fail fast, with the known names) -------------
        self.aggregator_name = aggregator
        self.allocator_name = allocator
        self.compressor_name = compressor
        aggregate = aggregators.get(aggregator)
        allocate = allocators.get(allocator)
        self.compressor: Compressor = get_compressor(compressor,
                                                     **(compressor_kw or {}))
        # the scenario decides how the wireless network evolves across
        # campaign rounds (channel dynamics axis; name or Scenario instance)
        self.scenario = get_scenario(scenario)
        # the topology decides the network *graph* — who talks to whom over
        # which hop (5th axis; ``star`` is the legacy flat graph and leaves
        # every path below bit-identical)
        self.topology = get_topology(topology)
        # the schedule decides how client work and server aggregation
        # interleave across campaign rounds (6th axis; ``sync`` is the
        # round-synchronous default and bit-identical to the pre-schedule
        # engine; ``pipelined``/``async``/``semi-async`` re-time — and for
        # the async family re-order — which client states feed aggregation,
        # all through value-only round-function arguments)
        self.schedule = get_schedule(schedule)
        # the local algorithm decides the client's inner update rule on
        # problem (4) (7th axis; ``gd`` is the paper's plain descent and
        # bit-identical to the pre-registry engine; ``fedprox``/``scaffold``
        # correct for client drift — the stateful scaffold variates live on
        # ``self.algo_state`` and ride the round function as value-only
        # arguments), and the workload decides what data each simulated
        # client sees (``iid`` is the legacy stream; the skew families are
        # the non-IID regimes the correctives exist for)
        self.local_algo = get_local_algo(local_algo)
        self.workload = get_workload(workload)
        # the population model decides how the K simulated clients map onto
        # simulated work (9th axis; ``exact`` is the default and
        # bit-identical — every hook is the identity; ``compact`` gathers
        # each async aggregation onto a fixed (C, …) window; ``meanfield``
        # additionally restricts the event timeline and the per-cell
        # allocator to seeded representatives and prices the FIFO/PS
        # backhaul queues analytically — see ``repro_torch.pop``)
        self.population = get_population(population)
        # campaign engine re-solves (reallocate=True) with the same strategy
        self._allocate = allocate
        self._eta_search = eta_search
        self.seed = seed
        # simulated campaign wall-clock accumulated so far; consecutive
        # run() calls continue it (checkpoint restore overrides it)
        self.campaign_time = 0.0

        # --- channel + allocation: the codec's uplink ratio rescales the
        # paper's s bits before the allocator prices the round.  A caller who
        # already sampled/solved (e.g. to compare strategies) can pass its
        # ``net``/``alloc`` to skip the re-solve. ----------------------------
        self.fcfg = dataclasses.replace(
            fcfg, s_bits=fcfg.s_bits * self.compressor.ratio)
        self.net = (self.scenario.initial_network(self.fcfg, seed)
                    if net is None else net)
        # hierarchical topologies re-anchor the wireless hop on each
        # client's attached edge; ``star`` is the identity (assign=None)
        self.net, self.assign = self.topology.localize(self.fcfg, self.net)
        # 'warm' needs an anchor η that doesn't exist yet at construction:
        # the initial solve runs the coarse sweep to *produce* the anchor,
        # and per-round re-solves (reallocate=True) then warm-start off it
        ctor_search = "coarse" if eta_search == "warm" else eta_search
        self.alloc: Allocation = (
            self.topology.allocate(self.fcfg, self.net, self.assign, allocate,
                                   strategy=allocator, eta_search=ctor_search)
            if alloc is None else alloc)
        if not self.alloc.feasible:
            raise ValueError(
                f"allocator {allocator!r} found no feasible allocation on the "
                f"constructor network (scenario {self.scenario.name!r}, "
                f"topology {self.topology.name!r}) — an infeasible Allocation "
                f"has eta=nan and cannot price an experiment")
        # η* prices the allocation; the training η is clamped so Lemma 2
        # still yields a non-trivial local-iteration count
        self.eta = (min(float(self.alloc.eta), self.fcfg.eta_train_max)
                    if eta is None else float(eta))
        # anchor of the 'warm' per-round η re-solve window: the η* the
        # constructor solve produced (NOT the clamped training η, and NOT
        # chained round-to-round) — fixed at construction so a resumed
        # campaign re-solves exactly what the uninterrupted one did
        self._eta0 = float(self.alloc.eta)
        # per-round wall-clock at the η the rounds actually train with
        # (I0/V/τ recomputed at self.eta; t_c/t_s from the allocation;
        # hierarchical topologies add the backhaul hop of each client's path)
        self.timing: RoundTiming = self.topology.round_timing(
            self.fcfg, self.net, self.alloc, self.eta, self.assign)

        # --- model + split + round functions --------------------------------
        # the weights come from ``seed``, or from the seed of the generator
        # ``key`` (the reference draws them from a jax key: the law is the
        # same, the values are not)
        self.state = fedsllm.init_state(cfg, self.cut,
                                        seed=seed if key is None else key.initial_seed(),
                                        device=self.device)
        # everything build_round_fn needs besides η — kept so set_eta can
        # build additional per-η round functions with identical semantics
        self._round_fn_kw = dict(
            remat=remat, dp_clip=dp_clip, dp_noise=dp_noise,
            aggregator=aggregate,
            compressor=(None if compressor == "none" else self.compressor),
            dp_seed=seed, two_tier=self.topology.two_tier,
            local_algo=self.local_algo)
        # stateful local algorithms (scaffold) carry per-client round-fn
        # state across rounds: (K, …)-stacked variates shaped like the
        # global LoRA pair, advanced by run_round, checkpointed by campaigns
        self.algo_state = self.local_algo.init_variates(
            (self.state.lora_c, self.state.lora_s), self.fcfg.num_clients)
        # per-η cache: η fixes Lemma 2's local-iteration count, so each η
        # has its own round function; trace_count counts the functions built
        # — a campaign must keep it ≤ the number of η buckets.
        self._traces = 0
        self._round_fns: dict[float, Any] = {}
        self._round_fn = self._round_fn_for(self.eta)

    # ------------------------------------------------------------------

    @classmethod
    def from_config(cls, run_cfg: RunConfig, **overrides) -> "Experiment":
        """Wire an experiment from a frozen :class:`RunConfig`.

        ``run_cfg.model`` supplies the architecture (a default LoRA config is
        attached if absent), ``run_cfg.fedsllm`` the §IV system model (paper
        defaults if absent) and ``run_cfg.train.seed`` the seed.
        ``scenario=`` selects the channel-dynamics family by name (or takes a
        ``repro_torch.sim.scenario.Scenario`` instance); the default ``blockfade``
        keeps the pre-scenario semantics bit-identical.  ``topology=``
        selects the network graph (``repro_torch.net.topology``): ``star`` (the
        flat default, bit-identical to the pre-topology engine) |
        ``edge-cloud`` | ``edge-agg`` | ``relay`` — non-star topologies
        need a geometry-carrying scenario (e.g. ``geo-blockfade``).
        ``schedule=`` selects the execution discipline
        (``repro_torch.des.schedules``): ``sync`` (the round-synchronous default,
        bit-identical to the pre-schedule engine) | ``pipelined`` |
        ``async`` | ``semi-async``.
        ``local_algo=`` selects the client local-update rule
        (``repro_torch.fl.local_algos``): ``gd`` (the paper's plain descent,
        bit-identical to the pre-registry engine) | ``fedprox`` |
        ``scaffold``; ``workload=`` the per-client data distribution
        (``repro_torch.fl.workloads``): ``iid`` (the legacy stream semantics) |
        ``quantity-skew`` | ``length-skew`` | ``dirichlet``.
        ``population=`` selects the client-population model
        (``repro_torch.pop``): ``exact`` (the default, bit-identical) |
        ``compact`` (fixed-window O(cohort) device batches under async
        schedules) | ``meanfield`` (plus representative timelines and
        analytic queue pricing — the mega-scale regime).
        ``run_cfg.shape`` is *not* consumed here: batch geometry comes from
        the ``batches`` pytree handed to :meth:`run_round` (shape configs
        drive the data-stream construction at call sites).  Keyword
        ``overrides`` go to ``__init__`` (e.g. ``aggregator="median"``;
        ``remat=True`` is an explicit opt-in, not inherited from
        ``train.remat``, so the round stays bit-identical to the shim path).
        """
        fcfg = run_cfg.fedsllm if run_cfg.fedsllm is not None else FedsLLMConfig()
        overrides.setdefault("seed", run_cfg.train.seed)
        return cls(run_cfg.model, fcfg, **overrides)

    # ------------------------------------------------------------------
    # per-η round functions

    def _round_fn_for(self, eta: float):
        """The round function for a training η (build+cache on miss).

        The cache key is the exact η the function was built with; callers
        that adopt a *solved* η* go through :meth:`set_eta`, which quantizes
        onto the ``fcfg.eta_bucket`` grid first so the number of round
        functions a campaign can build is bounded by the bucket count.
        """
        key = round(float(eta), 10)
        fn = self._round_fns.get(key)
        if fn is None:
            fn = fedsllm.build_round_fn(self.cfg, self.fcfg, self.cut, eta,
                                        **self._round_fn_kw)
            self._traces += 1
            self._round_fns[key] = fn
        return fn

    def set_eta(self, eta: float) -> float:
        """Adopt a new training η (quantized), switching the round function.

        ``eta`` — typically a freshly solved η* — is snapped onto the
        ``fcfg.eta_bucket`` grid and clamped to ``fcfg.eta_train_max``; the
        matching round function is fetched from the per-η cache (built
        on first use).  Returns the η actually adopted.  This is how
        ``reallocate=True`` campaigns re-solve Lemma 1/2 jointly every round
        while keeping ``trace_count`` ≤ the number of η buckets.

        Non-finite η is rejected loudly: an infeasible Allocation carries
        ``eta=nan``, and silently adopting a fabricated η would train the
        campaign on a round the allocator could not actually solve.
        """
        if not np.isfinite(eta):
            raise ValueError(
                f"cannot adopt non-finite eta {eta!r} — an infeasible "
                f"allocation has no solved η* (see allocation._infeasible)")
        q = quantize_eta(eta, self.fcfg.eta_bucket, self.fcfg.eta_train_max)
        if q != self.eta:
            self.eta = q
            self._round_fn = self._round_fn_for(q)
        return q

    def reprice_timing(self) -> RoundTiming:
        """Re-price the simulated round timing at the current (net, alloc, η).

        The campaign engine calls this after every per-round channel/η
        update; standalone callers that mutate ``net``/``alloc`` or call
        :meth:`set_eta` directly should too, so ``wall_clock_per_round``
        reflects what the rounds actually cost.  Hierarchical topologies
        compose the backhaul hop into every client's critical path.
        """
        self.timing = self.topology.round_timing(self.fcfg, self.net,
                                                 self.alloc, self.eta,
                                                 self.assign)
        return self.timing

    @property
    def eta_buckets(self) -> list[float]:
        """The η values with a built round function (the cache keys)."""
        return sorted(self._round_fns)

    # ------------------------------------------------------------------

    @property
    def cohort(self) -> int:
        """Clients trained per round (= the simulated radio population K)."""
        return self.fcfg.num_clients

    @property
    def round_fn(self):
        """The underlying round function (for benchmarking/inspection)."""
        return self._round_fn

    @property
    def trace_count(self) -> int:
        """Round functions built (``build_round_fn`` calls), one per η bucket.

        The reference counts jit traces of the same functions. A fixed-η
        campaign keeps this at 1: per-round masks, weights and batches are
        arguments, never a reason to build. A joint-η campaign
        (``reallocate=True``) keeps it ≤ the number of η buckets
        (``len(eta_buckets)``) — each bucket is built at most once."""
        return self._traces

    @property
    def wall_clock_per_round(self) -> float:
        """Simulated wireless wall-clock of one global round (slowest client,
        seconds), at the η the rounds actually train with."""
        return float(np.max(self.timing.total))

    def client_weights(self, num_clients: int) -> torch.Tensor:
        """Aggregation weights D_k for a cohort of the first ``num_clients``
        simulated users (the paper's data-size-weighted FedAvg)."""
        return self._f32(self.net.D_k[:num_clients])

    def _f32(self, a) -> torch.Tensor:
        """A host array as an fp32 tensor on the experiment's device, cast on
        the host as the reference's ``jnp.asarray(a, jnp.float32)`` does."""
        return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

    def run_round(self, batches, key: Optional[torch.Generator] = None,
                  mask: Optional[torch.Tensor] = None,
                  client_ids: Optional[np.ndarray] = None,
                  weight_scale: Optional[np.ndarray] = None,
                  update_scale: Optional[float] = None) -> RoundResult:
        """One global round: train (Algorithms 1+2) + simulated wall-clock.

        ``batches``: pytree with leaves stacked ``(C, ...)``, one slice per
        cohort client.  ``mask``: optional ``(C,)`` survivor mask.
        ``client_ids``: which simulated users this cohort is (aggregation
        weights become their ``D_k``); default: the first ``C`` users.
        ``weight_scale``: optional ``(C,)`` multiplier on the D_k weights —
        the async schedules' relative staleness discount ``1/(1+s)^β``
        rides here, an argument like the mask.
        ``update_scale``: optional scalar server mixing rate α on the
        aggregated update (Δw ← Δw + α·h̄) — the async schedules' ABSOLUTE
        staleness damping (a normalized weighted mean cancels any common
        per-client discount, so damping must scale the update itself).
        ``key``: optional ``torch.Generator`` for the DP noise; when None, a
        per-round generator is seeded from the experiment seed and the
        global round counter (so noise never repeats across rounds).

        Under a two-tier topology (``edge-agg``) the cohort's one-hot
        client→edge membership rides along as an argument, so the per-edge
        aggregation tracks re-attachment.
        """
        C = tree_leaves(batches)[0].shape[0]
        ids = (np.arange(C) if client_ids is None
               else np.asarray(client_ids))
        if client_ids is None:
            weights = self.client_weights(C)
        else:
            weights = self._f32(self.net.D_k[ids])
        if weight_scale is not None:
            weights = weights * self._f32(weight_scale)
        assign = None
        if self.topology.two_tier and self.assign is not None:
            M = self.topology.num_edges
            assign = self._f32(np.eye(M, dtype=np.float32)[np.asarray(self.assign)[ids]])
        scale = (None if update_scale is None
                 else self._f32(update_scale))
        if self.local_algo.stateful:
            # cohort→population row map for the variates: an argument, so
            # elastic cohorts reuse the same round function
            algo_ids = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
            self.state, metrics, self.algo_state = self._round_fn(
                self.state, batches, mask, key, weights, assign, scale,
                self.algo_state, algo_ids)
        else:
            self.state, metrics = self._round_fn(self.state, batches, mask,
                                                 key, weights, assign, scale)
        return RoundResult(self.state, metrics, self.timing)

    def run(self, num_rounds: Optional[int] = None, **kwargs) -> "CampaignResult":
        """Run a multi-round campaign (the ``repro_torch.sim`` engine).

        Per-round channel re-sampling (``resample_channel=True``, optionally
        ``reallocate=True``), elastic cohorts (``cohort=``), deadline
        straggler masks (``deadline=`` seconds), Lemma-1 stopping
        (``stop_at_lemma1=True``) and periodic checkpointing
        (``checkpoint_dir=``/``checkpoint_every=``/``resume=``).  Data comes
        from exactly one of ``stream=``/``batches=``/``batches_fn=``; see
        :func:`repro_torch.sim.campaign.run_campaign` for the full contract.

        ``num_rounds`` is the campaign's absolute length — rounds run from
        the state's current global round counter, so consecutive ``run``
        calls continue the same scenario rather than replaying it.  On a
        fresh experiment, ``run(num_rounds=1, resample_channel=False,
        batches=b)`` is bit-identical to ``run_round(b)``; the whole
        campaign reuses one round function (``trace_count`` stays at 1).
        """
        from repro_torch.sim.campaign import run_campaign

        return run_campaign(self, num_rounds, **kwargs)

    @classmethod
    def sweep(cls, run_cfg: RunConfig, **kwargs) -> "SweepResult":
        """Fan a grid of scenarios × allocators into one tidy records table.

        Builds one experiment per (scenario, allocator) cell from the same
        ``RunConfig``, runs the same campaign through each, and returns a
        :class:`repro_torch.sim.sweep.SweepResult` — long-format per-round records
        plus per-cell summaries and the paper's delay-reduction comparison
        (``proposed`` vs ``BA``) per scenario family.  See
        :func:`repro_torch.sim.sweep.run_sweep` for the full contract.

            res = Experiment.sweep(run_cfg, num_rounds=10, stream=stream,
                                   scenarios=("blockfade", "geo-blockfade"),
                                   allocators=("proposed", "BA"))
            res.summary(), res.delay_reduction()
        """
        from repro_torch.sim.sweep import run_sweep

        return run_sweep(run_cfg, **kwargs)

    def describe(self) -> str:
        from repro_torch.core.lora import lora_param_count

        return (f"Experiment[{self.cfg.name}] cut={self.cut}/{self.cfg.num_groups} "
                f"lora={lora_param_count(self.cfg)/1e6:.2f}M "
                f"agg={self.aggregator_name} alloc={self.allocator_name} "
                f"codec={self.compressor_name} scenario={self.scenario.name} "
                f"topo={self.topology.name} sched={self.schedule.name} "
                f"algo={self.local_algo.name} workload={self.workload.name} "
                f"pop={self.population.name} "
                f"T*={self.alloc.T:.1f}s η*={self.alloc.eta:.2f} "
                f"round={float(np.max(self.timing.total)):.2f}s")
