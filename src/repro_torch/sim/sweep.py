"""Topology × scenario × allocator × schedule × local-algo × workload ×
population sweep (port of ``repro/sim/sweep.py``).

One call fans a grid of network topologies × channel-dynamics scenarios ×
resource-allocation strategies × execution schedules × local-update
algorithms × data workloads × client-population models (``repro_torch.pop``:
``exact`` | ``compact`` | ``meanfield``) into identical campaigns over the same
``RunConfig``, collecting every round of every cell into one tidy
long-format records table — the shape the paper's Fig. 2 comparison wants:
the proposed allocator's delay reduction vs the BA baseline, reproducible
across every scenario family (mobility, device tiers, outages, …), per
network graph (flat star vs hierarchical edge-cloud, …), per execution
discipline (round-synchronous vs pipelined vs asynchronous —
``repro_torch.des.schedules``), and per client-drift regime: the
``local_algos`` axis (``gd`` | ``fedprox`` | ``scaffold``) crossed with the
``workloads`` axis (``iid`` | the skew families) is where the learning-side
strategies finally separate (``repro_torch.fl``).

    res = run_sweep(run_cfg, num_rounds=10, stream=stream,
                    topologies=("star", "edge-cloud"),
                    scenarios=("geo-blockfade", "drift"),
                    allocators=("proposed", "BA"),
                    schedules=("sync", "pipelined"),
                    local_algos=("gd", "fedprox", "scaffold"),
                    workloads=("iid", "dirichlet"))
    res.summary()           # one row per grid cell
    res.delay_reduction()   # % delay saved vs BA, per remaining grid axes
    res.schedule_speedup()  # % simulated time saved vs the sync schedule
    res.local_algo_gain()   # % final-loss reduction vs gd, per cell
    res.to_json("results/SWEEP_torch.json")

Also a CLI, on the card unless ``--device cpu``; it writes
``results/SWEEP_torch.json`` by default, beside the reference's
``results/SWEEP.json``:

    PYTHONPATH=src python -m repro_torch.sim.sweep --smoke --device cpu \
        --local-algos gd fedprox --workloads iid dirichlet \
        --allocators EB --rounds 2
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from itertools import product
from typing import Optional, Sequence

import numpy as np

DEFAULT_SCENARIOS = ("blockfade", "geo-blockfade")


def _topo_label(spec) -> str:
    """Record/JSON label of a topology grid entry.

    Names pass through; ``Topology`` instances label as ``name`` or
    ``name+<backhaul_model>`` under a queued backhaul, so the queued
    variant of a graph is a distinct grid cell from its serial default
    (the records table is JSON — it carries labels, never objects).
    """
    if isinstance(spec, str):
        return spec
    model = getattr(spec, "backhaul_model", "serial")
    return spec.name if model == "serial" else f"{spec.name}+{model}"
DEFAULT_ALLOCATORS = ("proposed", "BA")
DEFAULT_TOPOLOGIES = ("star",)
DEFAULT_SCHEDULES = ("sync",)
DEFAULT_LOCAL_ALGOS = ("gd",)
DEFAULT_WORKLOADS = ("iid",)
DEFAULT_POPULATIONS = ("exact",)


def _pop_label(spec) -> str:
    """Record/JSON label of a population grid entry (name or instance)."""
    return spec if isinstance(spec, str) else spec.name


@dataclass
class SweepResult:
    """A finished sweep: long-format per-round records + grid metadata."""

    records: list[dict]  # one dict per (topology, scenario, allocator,
    #                      schedule, local_algo, workload, population, round)
    scenarios: tuple[str, ...]
    allocators: tuple[str, ...]
    num_rounds: int
    meta: dict = field(default_factory=dict)  # cell-level info (traces, η*…)
    topologies: tuple[str, ...] = DEFAULT_TOPOLOGIES
    schedules: tuple[str, ...] = DEFAULT_SCHEDULES
    local_algos: tuple[str, ...] = DEFAULT_LOCAL_ALGOS
    workloads: tuple[str, ...] = DEFAULT_WORKLOADS
    populations: tuple[str, ...] = DEFAULT_POPULATIONS

    _AXIS_ARG = {"topologies": "topology", "schedules": "schedule",
                 "local_algos": "local_algo", "workloads": "workload",
                 "populations": "population"}

    def cell(self, scenario: str, allocator: str,
             topology: Optional[str] = None,
             schedule: Optional[str] = None,
             local_algo: Optional[str] = None,
             workload: Optional[str] = None,
             population: Optional[str] = None) -> list[dict]:
        """The per-round records of one grid cell, in round order.

        ``topology``/``schedule``/``local_algo``/``workload``/``population``
        may be omitted only when the grid has a single entry on that axis
        (the pre-axis call signatures); on a multi-entry grid an explicit
        name is required — silently merging graphs, disciplines or drift
        regimes would hand callers interleaved rounds from different
        campaigns."""
        topology = self._only("topologies", topology)
        schedule = self._only("schedules", schedule)
        local_algo = self._only("local_algos", local_algo)
        workload = self._only("workloads", workload)
        population = self._only("populations", population)
        return [r for r in self.records
                if r["scenario"] == scenario and r["allocator"] == allocator
                and r.get("topology", "star") == topology
                and r.get("schedule", "sync") == schedule
                and r.get("local_algo", "gd") == local_algo
                and r.get("workload", "iid") == workload
                and r.get("population", "exact") == population]

    def _only(self, axis: str, value: Optional[str]) -> str:
        entries = getattr(self, axis)
        if value is None:
            if len(entries) > 1:
                arg = self._AXIS_ARG[axis]
                raise ValueError(f"this sweep spans {axis} {entries}; pass "
                                 f"cell(scenario, allocator, {arg}=...)")
            return entries[0]
        return value

    def _grid(self):
        yield from product(self.topologies, self.scenarios, self.allocators,
                           self.schedules, self.local_algos, self.workloads,
                           self.populations)

    def _key(self, topology: str, scenario: str, schedule: str,
             local_algo: str = None, workload: str = None,
             population: str = None) -> str:
        """Reporting key: scenario, prefixed/suffixed by whichever extra
        axes the grid actually spans (single-axis grids keep the short
        pre-axis keys, e.g. ``"blockfade"`` or ``"star/blockfade"``)."""
        key = scenario if len(self.topologies) == 1 else f"{topology}/{scenario}"
        if len(self.schedules) > 1:
            key = f"{key}/{schedule}"
        if local_algo is not None and len(self.local_algos) > 1:
            key = f"{key}/{local_algo}"
        if workload is not None and len(self.workloads) > 1:
            key = f"{key}/{workload}"
        if population is not None and len(self.populations) > 1:
            key = f"{key}/{population}"
        return key

    def summary(self) -> list[dict]:
        """One row per cell: simulated campaign time, final loss, stragglers."""
        out = []
        for t, s, a, d, la, w, p in self._grid():
            rows = self.cell(s, a, t, d, la, w, p)
            if not rows:
                continue
            slots = sum(r["cohort_size"] for r in rows)
            lost = sum(r["cohort_size"] - r["survivors"] for r in rows)
            out.append({
                "topology": t, "scenario": s, "allocator": a, "schedule": d,
                "local_algo": la, "workload": w, "population": p,
                "rounds": len(rows),
                "total_time": rows[-1]["cumulative_time"],
                "final_loss": rows[-1]["loss_round_start"],
                "straggler_rate": lost / max(slots, 1),
                **self.meta.get((t, s, a, d, la, w, p), {}),
            })
        return out

    def delay_reduction(self, allocator: str = "proposed",
                        baseline: str = "BA") -> dict[str, float]:
        """% reduction in simulated campaign delay — the paper's headline
        comparison (47.63% on the frozen draw), per scenario family and,
        when the grid spans several topologies/schedules, per network graph
        and per execution discipline (keys become
        ``"topology/scenario[/schedule]"``)."""
        out = {}
        for t, s, d, la, w, p in product(self.topologies, self.scenarios,
                                         self.schedules, self.local_algos,
                                         self.workloads, self.populations):
            a = self.cell(s, allocator, t, d, la, w, p)
            b = self.cell(s, baseline, t, d, la, w, p)
            if a and b and b[-1]["cumulative_time"] > 0:
                out[self._key(t, s, d, la, w, p)] = 100.0 * (
                    1.0 - a[-1]["cumulative_time"]
                    / b[-1]["cumulative_time"])
        return out

    def schedule_speedup(self, baseline: str = "sync") -> dict[str, float]:
        """% simulated campaign time saved by each non-baseline schedule vs
        ``baseline`` on the same (topology, scenario, allocator) cell —
        the event-driven counterpart of ``delay_reduction`` (keys
        ``"topology/scenario/allocator/schedule"``; requires the baseline
        schedule in the grid)."""
        out = {}
        if baseline not in self.schedules:
            return out
        for t, s, a, la, w, p in product(self.topologies, self.scenarios,
                                         self.allocators, self.local_algos,
                                         self.workloads, self.populations):
            base = self.cell(s, a, t, baseline, la, w, p)
            if not base or base[-1]["cumulative_time"] <= 0:
                continue
            for d in self.schedules:
                if d == baseline:
                    continue
                rows = self.cell(s, a, t, d, la, w, p)
                if rows:
                    key = f"{t}/{s}/{a}/{d}"
                    if len(self.local_algos) > 1:
                        key = f"{key}/{la}"
                    if len(self.workloads) > 1:
                        key = f"{key}/{w}"
                    if len(self.populations) > 1:
                        key = f"{key}/{p}"
                    out[key] = 100.0 * (
                        1.0 - rows[-1]["cumulative_time"]
                        / base[-1]["cumulative_time"])
        return out

    def local_algo_gain(self, baseline: str = "gd") -> dict[str, float]:
        """% final-loss reduction of each non-baseline local algorithm vs
        ``baseline`` on the same (topology, scenario, allocator, schedule,
        workload) cell — positive means the drift-corrected algorithm ended
        the campaign at a lower global loss.  The final loss is the last
        round's ``loss_round_start`` (the global model after every previous
        aggregation), the same convention as ``summary()``.  Keys are
        ``"scenario[/…]/workload/local_algo"``; requires the baseline
        algorithm in the grid."""
        out = {}
        if baseline not in self.local_algos:
            return out
        for t, s, a, d, w, p in product(self.topologies, self.scenarios,
                                        self.allocators, self.schedules,
                                        self.workloads, self.populations):
            base = self.cell(s, a, t, d, baseline, w, p)
            if not base or base[-1]["loss_round_start"] <= 0:
                continue
            for la in self.local_algos:
                if la == baseline:
                    continue
                rows = self.cell(s, a, t, d, la, w, p)
                if rows:
                    key = f"{self._key(t, s, d)}/{w}/{la}"
                    if len(self.allocators) > 1:
                        key = f"{a}:{key}"
                    if len(self.populations) > 1:
                        key = f"{key}/{p}"
                    out[key] = 100.0 * (
                        1.0 - rows[-1]["loss_round_start"]
                        / base[-1]["loss_round_start"])
        return out

    def to_json(self, path: str) -> str:
        """Write the records table (+ summary) as a machine-readable artifact."""
        # label the headline comparison explicitly (and don't fabricate a
        # 0% self-comparison when the grid has a single allocator)
        reduction = None
        if len(self.allocators) >= 2:
            allocator, baseline = self.allocators[0], self.allocators[-1]
            reduction = {"allocator": allocator, "baseline": baseline,
                         "pct_by_scenario": self.delay_reduction(allocator,
                                                                 baseline)}
        payload = {
            "topologies": list(self.topologies),
            "scenarios": list(self.scenarios),
            "allocators": list(self.allocators),
            "schedules": list(self.schedules),
            "local_algos": list(self.local_algos),
            "workloads": list(self.workloads),
            "populations": list(self.populations),
            "num_rounds": self.num_rounds,
            "records": self.records,
            "summary": self.summary(),
            "delay_reduction": reduction,
            "schedule_speedup_pct": (self.schedule_speedup()
                                     if len(self.schedules) >= 2 else None),
            "local_algo_gain_pct": (self.local_algo_gain()
                                    if len(self.local_algos) >= 2 else None),
        }
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        return path


def run_sweep(run_cfg, num_rounds: int, *,
              scenarios: Sequence[str] = DEFAULT_SCENARIOS,
              allocators: Sequence[str] = DEFAULT_ALLOCATORS,
              topologies: Sequence[str] = DEFAULT_TOPOLOGIES,
              schedules: Sequence[str] = DEFAULT_SCHEDULES,
              local_algos: Sequence[str] = DEFAULT_LOCAL_ALGOS,
              workloads: Sequence[str] = DEFAULT_WORKLOADS,
              populations: Sequence[str] = DEFAULT_POPULATIONS,
              stream=None, batches=None, batches_fn=None,
              exp_overrides: Optional[dict] = None,
              **campaign_kw) -> SweepResult:
    """Run the same campaign through every (topology, scenario, allocator,
    schedule, local_algo, workload, population) cell.

    Each cell builds a fresh ``Experiment`` from ``run_cfg`` (so cells are
    independent and individually deterministic — the whole sweep is a pure
    function of ``(run_cfg, grid)``), then drives ``num_rounds`` rounds with
    identical data/cohort/deadline settings.  ``exp_overrides`` forwards
    extra ``Experiment.from_config`` keywords to every cell (e.g.
    ``{"eta_search": "coarse", "cut": 1}``); ``campaign_kw`` forwards to
    ``Experiment.run`` (e.g. ``cohort=``, ``deadline=``, ``reallocate=``).
    Non-star topologies need geometry-carrying scenarios in the grid (e.g.
    ``geo-blockfade``/``drift`` — not the legacy ``blockfade``); async
    schedules run the full population regardless of ``cohort=``; non-``iid``
    workloads shape per-client *stream* reads, so they require ``stream=``.

    Returns a :class:`SweepResult` whose ``records`` are tidy long-format
    rows — one per round per cell — ready for a dataframe or ``to_json``.
    """
    from repro_torch.api.experiment import Experiment  # deferred: import cycle

    if stream is None and any(w != "iid" for w in workloads):
        raise ValueError(f"workloads={tuple(workloads)} include non-iid "
                         f"entries, which require stream= data")
    exp_overrides = dict(exp_overrides or {})
    records: list[dict] = []
    meta: dict = {}
    for t, s, a, d, la, w, p in product(topologies, scenarios, allocators,
                                        schedules, local_algos, workloads,
                                        populations):
        exp = Experiment.from_config(run_cfg, scenario=s,
                                     allocator=a, topology=t,
                                     schedule=d, local_algo=la,
                                     workload=w, population=p,
                                     **exp_overrides)
        t = _topo_label(t)  # instances become labels in records/meta
        p = _pop_label(p)
        res = exp.run(num_rounds=num_rounds, stream=stream,
                      batches=batches, batches_fn=batches_fn,
                      **campaign_kw)
        for rec in res.records:
            records.append({
                "topology": t, "scenario": s, "allocator": a,
                "schedule": d, "local_algo": la, "workload": w,
                "population": p,
                "round": rec.round,
                "eta": rec.eta, "alloc_T": float(rec.alloc.T),
                "cohort_size": rec.cohort_size,
                "survivors": rec.survivors,
                "round_time": rec.round_time,
                "cumulative_time": rec.cumulative_time,
                **rec.metrics,
            })
        meta[(t, s, a, d, la, w, p)] = {"trace_count": exp.trace_count,
                                        "eta_star": float(exp.alloc.eta),
                                        "eta_buckets": len(exp.eta_buckets)}
    return SweepResult(records=records, scenarios=tuple(scenarios),
                       allocators=tuple(allocators), num_rounds=num_rounds,
                       meta=meta,
                       topologies=tuple(_topo_label(t) for t in topologies),
                       schedules=tuple(schedules),
                       local_algos=tuple(local_algos),
                       workloads=tuple(workloads),
                       populations=tuple(_pop_label(p) for p in populations))


def main(argv: Optional[list[str]] = None) -> None:
    """CLI sweep (the CI smoke): small grid on the smoke arch, JSON out."""
    import argparse

    from repro_torch.config import (FedsLLMConfig, LoRAConfig, RunConfig, SHAPES,
                                    get_arch, smoke_variant)
    from repro_torch.data.tokens import TokenStream

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="fedsllm-100m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--scenarios", nargs="+", default=list(DEFAULT_SCENARIOS))
    ap.add_argument("--allocators", nargs="+", default=list(DEFAULT_ALLOCATORS))
    ap.add_argument("--topologies", nargs="+",
                    default=list(DEFAULT_TOPOLOGIES),
                    help="network graphs (repro_torch.net.topology); non-star "
                         "need geometry scenarios like geo-blockfade")
    ap.add_argument("--schedules", nargs="+", default=list(DEFAULT_SCHEDULES),
                    help="execution disciplines (repro_torch.des.schedules): "
                         "sync | pipelined | async | semi-async")
    ap.add_argument("--local-algos", nargs="+",
                    default=list(DEFAULT_LOCAL_ALGOS),
                    help="client local-update rules (repro_torch.fl.local_algos): "
                         "gd | fedprox | scaffold")
    ap.add_argument("--workloads", nargs="+", default=list(DEFAULT_WORKLOADS),
                    help="per-client data distributions "
                         "(repro_torch.fl.workloads): iid | quantity-skew | "
                         "length-skew | dirichlet")
    ap.add_argument("--populations", nargs="+",
                    default=list(DEFAULT_POPULATIONS),
                    help="client-population models (repro_torch.pop): exact | "
                         "compact | meanfield — 'compact'/'meanfield' make "
                         "large --clients campaigns O(cohort) per round")
    ap.add_argument("--backhaul-model", default="serial",
                    choices=("serial", "fifo", "ps"),
                    help="edge→cloud backhaul discipline for every "
                         "hierarchical topology on the grid: 'serial' is "
                         "the legacy per-cell pipe; 'fifo'/'ps' share one "
                         "queued metro link and turn on the wait-aware "
                         "allocator loop (cells label as e.g. "
                         "'edge-cloud+fifo')")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--reallocate", action="store_true",
                    help="re-solve η jointly every round")
    ap.add_argument("--eta", type=float, default=None,
                    help="pin the training η (default: clamped η*)")
    ap.add_argument("--out", default=os.path.join("results", "SWEEP_torch.json"))
    ap.add_argument("--device", default="cuda", help="where the model trains")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg).replace(lora=LoRAConfig(rank=4))
    run_cfg = RunConfig(model=cfg, shape=SHAPES["train_4k"],
                        fedsllm=FedsLLMConfig(num_clients=args.clients))
    stream = TokenStream(2, 32 if args.smoke else 64, cfg.vocab_size, seed=0,
                         device=args.device)
    overrides = {"device": args.device}
    if args.eta is not None:
        overrides["eta"] = args.eta
    topo_grid = list(args.topologies)
    if args.backhaul_model != "serial":
        from repro_torch.net.topology import get_topology

        # star has no backhaul leg — only hierarchical graphs re-instantiate
        topo_grid = [t if t == "star" else
                     type(get_topology(t))(backhaul_model=args.backhaul_model)
                     for t in topo_grid]
    res = run_sweep(run_cfg, args.rounds, scenarios=args.scenarios,
                    allocators=args.allocators, topologies=topo_grid,
                    schedules=args.schedules, local_algos=args.local_algos,
                    workloads=args.workloads, populations=args.populations,
                    stream=stream,
                    cohort=args.cohort, reallocate=args.reallocate,
                    exp_overrides=overrides)
    for row in res.summary():
        print(",".join(f"{k}={v}" for k, v in row.items()), flush=True)
    if len(args.allocators) >= 2:
        for s, pct in res.delay_reduction(args.allocators[0],
                                          args.allocators[-1]).items():
            print(f"# {s}: {args.allocators[0]} vs {args.allocators[-1]} "
                  f"delay reduction {pct:.2f}%")
    for key, pct in res.schedule_speedup().items():
        print(f"# {key}: simulated time saved vs sync {pct:.2f}%")
    for key, pct in res.local_algo_gain().items():
        print(f"# {key}: final-loss reduction vs gd {pct:.2f}%")
    print(f"# wrote {res.to_json(args.out)} ({len(res.records)} records)")


if __name__ == "__main__":
    main()
