"""The port's event engine, execution schedules, ``events.round_state``,
population models (with ``population=`` through ``net/*``), workloads and the
pipeline latency model, against the reference.

All of it is host-side numpy (the workloads stack tensors), copied from the
reference: plans, event order, round pricing, queue hops, windows and the
per-client data positions must be bit-identical. Campaign records are
compared from "planning" campaigns, in which both experiments skip the
training step (``run_round`` returns the state as it is): every record field
but the metrics is the schedule's and the simulator's. One async campaign
trains as well, its metrics within the round tolerance.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from repro.api import RoundResult as JaxRoundResult
from repro.core import delay_model as jax_dm
from repro.des import engine as jax_engine
from repro.net import topology as jax_topology
from repro.parallel import pipeline as jax_pipeline
from repro.pop import meanfield as jax_meanfield
from repro.pop import population as jax_population
from repro.sim import events as jax_events
from repro_torch.api import RoundResult
from repro_torch.core import delay_model as dm
from repro_torch.data.tokens import TokenStream
from repro_torch.des import engine
from repro_torch.net import topology
from repro_torch.parallel import pipeline
from repro_torch.pop import meanfield, population
from repro_torch.sim import events
from test_torch_alloc import assert_same, configs
from test_torch_experiment import (ROUND, assert_records_match, lora_gap, pair, run_configs,
                                   streams)

# the packages export the registries under the modules' names
jax_schedules = importlib.import_module("repro.des.schedules")
jax_workloads = importlib.import_module("repro.fl.workloads")
schedules = importlib.import_module("repro_torch.des.schedules")
workloads = importlib.import_module("repro_torch.fl.workloads")

K = 6


@pytest.fixture(scope="module")
def cfgs():
    return run_configs(K=K)


@pytest.fixture(scope="module")
def data(cfgs):
    return streams(cfgs[1].model.vocab_size)


# ---------------------------------------------------------------------------
# the event engine
# ---------------------------------------------------------------------------


def _drive(mod, stop_after=None, until=None):
    """The same schedule of events, with ties, and a handler that schedules
    follow-ups, through one package's engine: the trace as tuples."""
    sim = mod.EventSim()
    rng = np.random.default_rng(0)
    for k, t in enumerate(np.round(rng.uniform(0, 5, 12), 0)):
        sim.schedule(float(t), "complete", client=k)
    seen = []

    def handler(s, ev):
        seen.append(ev.seq)
        if ev.kind == "complete" and ev.data["client"] % 3 == 0:
            s.after(0.5 * (ev.data["client"] % 2), "retry", client=ev.data["client"] + 100)
        if stop_after is not None and len(seen) == stop_after:
            s.stop()

    trace = sim.run(handler, until=until)
    return [(e.time, e.seq, e.kind, e.data) for e in trace], sim.pending, sim.now


@pytest.mark.parametrize("stop_after,until", [(None, None), (5, None), (None, 2.0)])
def test_engine_trace_matches_reference(stop_after, until):
    got = _drive(engine, stop_after, until)
    assert got == _drive(jax_engine, stop_after, until)
    times = [(t, s) for t, s, _, _ in got[0]]
    assert times == sorted(times)


def test_engine_errors_match_reference():
    for mod in (engine, jax_engine):
        sim = mod.EventSim()
        sim.schedule(1.0, "a")
        sim.run()
        with pytest.raises(ValueError, match="in the past"):
            sim.schedule(0.5, "b")
        with pytest.raises(ValueError, match="negative delay"):
            sim.after(-1.0, "b")
        sim.schedule(2.0, "loop")
        with pytest.raises(RuntimeError, match="event budget"):
            sim.run(lambda s, ev: s.after(0.0, "loop"), max_events=50)


# ---------------------------------------------------------------------------
# the pipeline latency model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 2, 4, 7])
def test_pipeline_model_bit_identical(M):
    jcfg, cfg = configs(num_clients=5)
    net, jnet = dm.sample_network(cfg, seed=M), jax_dm.sample_network(jcfg, seed=M)
    from repro.api.allocators import get_allocator as jax_get_allocator
    from repro_torch.api.allocators import get_allocator

    alloc = get_allocator("EB")(cfg, net)
    jalloc = jax_get_allocator("EB")(jcfg, jnet)
    for eta, frac in ((0.3, 0.1), (0.9, 0.0)):
        stages = pipeline.split_stage_times(cfg, net, eta, alloc.A, alloc, downlink_frac=frac)
        jstages = jax_pipeline.split_stage_times(jcfg, jnet, eta, jalloc.A, jalloc,
                                                 downlink_frac=frac)
        assert_same(stages, jstages)
        assert_same(pipeline.pipeline_round_time(stages, M),
                    jax_pipeline.pipeline_round_time(jstages, M))


# ---------------------------------------------------------------------------
# schedules: registry, validation, plans
# ---------------------------------------------------------------------------


def test_schedule_registry_and_validation_match_reference():
    assert schedules.schedules.names() == jax_schedules.schedules.names()
    for name in schedules.schedules.names():
        s, js = schedules.get_schedule(name), jax_schedules.get_schedule(name)
        assert (s.name, s.params()) == (js.name, js.params())
    inst = schedules.PipelinedSchedule(num_microbatches=8)
    assert schedules.get_schedule(inst) is inst
    assert schedules.get_schedule(schedules.AsyncSchedule).params() == \
        jax_schedules.get_schedule(jax_schedules.AsyncSchedule).params()
    with pytest.raises(KeyError, match="known"):
        schedules.get_schedule("lockstep")
    for bad in (lambda m: m.PipelinedSchedule(num_microbatches=0),
                lambda m: m.AsyncSchedule(beta=-1.0), lambda m: m.AsyncSchedule(buffer_k=0)):
        with pytest.raises(ValueError) as got:
            bad(schedules)
        with pytest.raises(ValueError) as want:
            bad(jax_schedules)
        assert str(got.value) == str(want.value)


def _planning(jexp, texp):
    """Both experiments skip training: a campaign then runs its simulator,
    schedule and population alone."""
    jexp.run_round = lambda batches, **kw: JaxRoundResult(jexp.state, {}, jexp.timing)
    texp.run_round = lambda batches, **kw: RoundResult(texp.state, {}, texp.timing)


def _both(name, kw):
    """The same schedule object in each package, by class name."""
    return ({"schedule": getattr(jax_schedules, name)(**kw)},
            {"schedule": getattr(schedules, name)(**kw)})


CELLS = [
    # (schedule, scenario, topology, deadline quantile, population, reallocate, cohort)
    ("sync", "blockfade", "star", 0.7, "exact", False, 4),
    ("sync", "drift", "edge-agg", 0.6, "exact", True, 6),
    ("pipelined", "geo-blockfade", "edge-cloud", 0.7, "exact", False, 4),
    (("PipelinedSchedule", {"num_microbatches": 3}), "geo-blockfade", "fifo", None, "exact",
     True, 5),
    ("async", "blockfade", "star", 0.9, "exact", False, 6),
    (("AsyncSchedule", {"beta": 0.8, "server_ps": True}), "geo-blockfade", "star", None,
     "compact", True, 3),
    ("semi-async", "drift", "ps", None, "meanfield", True, 4),
    (("SemiAsyncSchedule", {"buffer_k": 2}), "outage", "relay", 0.75, "meanfield", False, 2),
]


@pytest.mark.parametrize("cell", CELLS, ids=[f"{c[0] if isinstance(c[0], str) else c[0][0]}-"
                                             f"{c[1]}-{c[2]}-{c[4]}" for c in CELLS])
def test_campaign_plans_match_reference(cfgs, data, cell):
    """Four planned rounds per cell: cohorts, masks, weight and update
    scales through the rounds' records, staleness, completions, the event
    records in order, round and cumulative times, networks priced, η and
    allocations, all bit for bit; a queued backhaul (``fifo``/``ps``) on
    the edge-cloud graph; the population model re-bound by the campaign."""
    sched, scen, topo, q, pop, realloc, cohort = cell
    jkw, tkw = _both(*sched) if not isinstance(sched, str) else ({}, {})
    kw = {} if not isinstance(sched, str) else {"schedule": sched}
    if topo in ("fifo", "ps"):
        jkw["topology"] = jax_topology.EdgeCloudTopology(backhaul_model=topo)
        tkw["topology"] = topology.EdgeCloudTopology(backhaul_model=topo)
    else:
        kw["topology"] = topo
    camp = dict(num_rounds=4, cohort=cohort, deadline=None, resample_channel=True,
                reallocate=realloc)
    if q is not None:
        # the q-quantile of the clients' planned completions (sync family) or
        # run durations (async: round j's simulated times) without a deadline
        probe = pair(cfgs, jkw=jkw, tkw=tkw, scenario=scen, population=pop, **kw)[1]
        _planning(probe, probe)
        recs = probe.run(stream=data[1], **camp).records
        members = probe.population.timeline_clients()  # meanfield: the representatives
        members = slice(None) if members is None else members
        times = (np.concatenate([r.completion for r in recs]) if recs[0].completion is not None
                 else np.concatenate([events.round_state(probe, 0, j, reallocate=realloc)[-1]
                                      .total[members] for j in range(4)]))
        camp["deadline"] = float(np.quantile(times, q))
    jkw, tkw = _both(*sched) if not isinstance(sched, str) else ({}, {})
    if topo in ("fifo", "ps"):
        jkw["topology"] = jax_topology.EdgeCloudTopology(backhaul_model=topo)
        tkw["topology"] = topology.EdgeCloudTopology(backhaul_model=topo)
    jexp, texp = pair(cfgs, jkw=jkw, tkw=tkw, scenario=scen, population=pop, **kw)
    _planning(jexp, texp)
    jres, tres = jexp.run(stream=data[0], **camp), texp.run(stream=data[1], **camp)
    assert_records_match(tres.records, jres.records)
    assert tres.total_time == jres.total_time and tres.schedule == jres.schedule
    assert texp.eta_buckets == jexp.eta_buckets
    if q is not None:  # the deadline bit: cancelled a run (async), or masked a client
        kinds = {e["kind"] for r in tres.records for e in r.events}
        assert "timeout" in kinds or any(r.stragglers for r in tres.records)


def test_planners_match_reference_directly(cfgs):
    """``planner.round_plan`` of the async timeline (deadline, timeouts,
    staleness) and of the per-round planners at the constructor's pricing."""
    for name, deadline in (("async", None), ("semi-async", None), ("sync", 3000.0),
                           ("pipelined", None)):
        jexp, texp = pair(cfgs, schedule=name, scenario="geo-blockfade")
        kw = dict(campaign_seed=0, start=0, target=5, cohort=K, fixed_cohort=None,
                  deadline=deadline, resample_channel=True, reallocate=False,
                  realloc_search="warm")
        jp, tp = jexp.schedule.planner(jexp, **kw), texp.schedule.planner(texp, **kw)
        for r in range(5 if name in ("async", "semi-async") else 1):
            assert_same(tp.round_plan(r, np.arange(K)), jp.round_plan(r, np.arange(K)))


def test_async_timeline_refusals_match_reference(cfgs):
    jexp, texp = pair(cfgs, jkw={"schedule": jax_schedules.SemiAsyncSchedule(buffer_k=K + 1)},
                      tkw={"schedule": schedules.SemiAsyncSchedule(buffer_k=K + 1)})
    base = dict(campaign_seed=0, start=0, target=2, cohort=K, fixed_cohort=None, deadline=None,
                resample_channel=True, reallocate=False, realloc_search="warm")
    for exp in (jexp, texp):
        with pytest.raises(ValueError, match="can never fill"):
            exp.schedule.planner(exp, **base)
    jexp, texp = pair(cfgs, schedule="async")
    for exp in (jexp, texp):
        with pytest.raises(ValueError, match="full population"):
            exp.schedule.planner(exp, **dict(base, fixed_cohort=2))
        with pytest.raises(RuntimeError, match="produced no aggregation"):
            exp.schedule.planner(exp, **dict(base, deadline=1e-9))


# ---------------------------------------------------------------------------
# events.round_state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("resample,reallocate", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("pop", ["exact", "meanfield"])
def test_round_state_matches_reference(cfgs, resample, reallocate, pop):
    """(net, assign, alloc, η, timing) of rounds 0–2 on a queued edge-cloud
    graph, the mean-field population bound to 3 representatives: bit for
    bit, and pure (the same call twice gives the same)."""
    jkw = {"topology": jax_topology.EdgeCloudTopology(backhaul_model="fifo"),
           "population": jax_meanfield.MeanFieldPopulation(window=2, reps=3)
           if pop == "meanfield" else pop}
    tkw = {"topology": topology.EdgeCloudTopology(backhaul_model="fifo"),
           "population": meanfield.MeanFieldPopulation(window=2, reps=3)
           if pop == "meanfield" else pop}
    jexp, texp = pair(cfgs, jkw=jkw, tkw=tkw, scenario="geo-blockfade")
    jexp.population.begin_campaign(K, 2, 5)
    texp.population.begin_campaign(K, 2, 5)
    for r in range(3):
        got = events.round_state(texp, 5, r, resample=resample, reallocate=reallocate)
        want = jax_events.round_state(jexp, 5, r, resample=resample, reallocate=reallocate)
        assert_same(got, want, f"round {r}")
        assert_same(events.round_state(texp, 5, r, resample=resample, reallocate=reallocate),
                    got)


# ---------------------------------------------------------------------------
# populations
# ---------------------------------------------------------------------------


def test_population_registry_matches_reference():
    assert population.populations.names() == jax_population.populations.names()
    for name in population.populations.names():
        p, jp = population.get_population(name), jax_population.get_population(name)
        assert (p.name, p.params()) == (jp.name, jp.params())
    with pytest.raises(KeyError, match="known"):
        population.get_population("sampled")
    for bad in (lambda m: m.CompactPopulation(window=0),
                lambda m: meanfield.MeanFieldPopulation(reps=0) if m is population
                else jax_meanfield.MeanFieldPopulation(reps=0)):
        with pytest.raises(ValueError):
            bad(population)
        with pytest.raises(ValueError):
            bad(jax_population)
    assert population.ExactPopulation().device_batch("batch") == "batch"
    assert population.CompactPopulation().device_batch("batch") == "batch"


@pytest.mark.parametrize("kind", ["compact", "meanfield"])
@pytest.mark.parametrize("round_idx", [0, 2, 3])
def test_compact_plan_matches_reference(kind, round_idx):
    """The window of 5 of 20 clients: arrivals first, then the round-keyed
    rotating fill (inside the representatives for meanfield)."""
    def make(mod, pmod):
        pop = (pmod.CompactPopulation(window=5) if kind == "compact"
               else pmod.MeanFieldPopulation(window=5, reps=8))
        pop.begin_campaign(20, 4, 3)
        mask = np.zeros(20, np.float32)
        mask[[3, 17]] = 1.0
        plan = mod.RoundPlan(round=round_idx, mask=mask, round_time=1.0,
                             client_ids=np.arange(20), weight_scale=np.linspace(0.1, 2.0, 20),
                             staleness=np.arange(20, dtype=float),
                             completion=np.linspace(1, 3, 20))
        return pop, pop.compact_plan(plan, np.arange(20), round_idx)

    (pop, got), (jpop, want) = make(schedules, meanfield if kind == "meanfield" else population), \
        make(jax_schedules, jax_meanfield if kind == "meanfield" else jax_population)
    assert_same(got, want)
    assert_same(pop.timeline_clients(), jpop.timeline_clients())


def _poisson_cells(seed, K_jobs=600, M=2, rate=45.0):
    rng = np.random.default_rng(seed)
    assign = np.repeat(np.arange(M), K_jobs // M)
    totals = np.empty(K_jobs)
    for m in range(M):
        totals[assign == m] = np.cumsum(rng.exponential(1.0 / rate, K_jobs // M))
    return assign, totals


@pytest.mark.parametrize("model", ["fifo", "ps"])
@pytest.mark.parametrize("graph", ["EdgeCloudTopology", "EdgeAggTopology", "RelayTopology"])
def test_meanfield_hop_and_its_wiring_match_reference(model, graph):
    """The analytic backhaul hop (with outage clients), and ``backhaul_hop``
    handing it to the population: bit for bit; the exact replay without one."""
    jcfg, cfg = configs(num_clients=40)
    assign, totals = _poisson_cells(1, K_jobs=40)
    totals[[5, 30]] = np.inf
    topo = getattr(topology, graph)(backhaul_bps=cfg.s_c_bits / 0.005, backhaul_model=model)
    jtopo = getattr(jax_topology, graph)(backhaul_bps=jcfg.s_c_bits / 0.005,
                                        backhaul_model=model)
    hop = meanfield.meanfield_backhaul_hop(topo, cfg, assign, 0.3, totals)
    assert_same(hop, jax_meanfield.meanfield_backhaul_hop(jtopo, jcfg, assign, 0.3, totals))
    assert hop[5] == hop[30] == 0.0
    pop, jpop = meanfield.MeanFieldPopulation(), jax_meanfield.MeanFieldPopulation()
    assert_same(topo.backhaul_hop(cfg, assign, 0.3, totals, population=pop), hop)
    assert_same(topo.backhaul_hop(cfg, assign, 0.3, totals, population=population.ExactPopulation()),
                jtopo.backhaul_hop(jcfg, assign, 0.3, totals))


@pytest.mark.parametrize("graph", ["edge-cloud", "edge-agg"])
@pytest.mark.parametrize("model", ["serial", "fifo"])
def test_population_through_allocation_matches_reference(graph, model):
    """``topology.allocate`` and ``round_timing`` with a mean-field
    population of 4 representatives among 12 clients (per-cell solves on the
    representatives, broadcast to every member; the analytic queue), and
    with none: bit for bit."""
    from repro.api.allocators import get_allocator as jax_get_allocator
    from repro.sim.scenario import get_scenario as jax_get_scenario
    from repro_torch.api.allocators import get_allocator
    from repro_torch.sim.scenario import get_scenario

    jcfg, cfg = configs(num_clients=12)
    topo = type(topology.get_topology(graph))(backhaul_model=model)
    jtopo = type(jax_topology.get_topology(graph))(backhaul_model=model)
    net, assign = topo.localize(cfg, get_scenario("geo-blockfade").initial_network(cfg, 2))
    jnet, jassign = jtopo.localize(jcfg, jax_get_scenario("geo-blockfade").initial_network(jcfg, 2))
    pop, jpop = meanfield.MeanFieldPopulation(window=4), jax_meanfield.MeanFieldPopulation(window=4)
    pop.begin_campaign(12, 4, 9)
    jpop.begin_campaign(12, 4, 9)
    assert_same(pop.rep_ids, jpop.rep_ids)
    for p, jp in ((pop, jpop), (None, None)):
        alloc = topo.allocate(cfg, net, assign, get_allocator("EB"), strategy="EB", population=p)
        jalloc = jtopo.allocate(jcfg, jnet, jassign, jax_get_allocator("EB"), strategy="EB",
                                population=jp)
        assert_same(alloc, jalloc)
        eta = min(float(alloc.eta), 0.5)
        assert_same(topo.round_timing(cfg, net, alloc, eta, assign, population=p),
                    jtopo.round_timing(jcfg, jnet, jalloc, eta, jassign, population=jp))


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------


WORKLOADS = [("iid", {}), ("quantity-skew", {"alpha": 0.3, "pool_rounds": 3}),
             ("length-skew", {"min_frac": 0.3}), ("dirichlet", {"alpha": 0.4, "num_domains": 3,
                                                                "domain_pool": 4})]


@pytest.mark.parametrize("name,kw", WORKLOADS, ids=[w for w, _ in WORKLOADS])
def test_workload_batches_match_reference(data, name, kw):
    """Each client's stream positions, pools, lengths and domain shards, so
    each stacked batch, bit for bit, for several rounds and cohorts."""
    w, jw = workloads.get_workload(name, **kw), jax_workloads.get_workload(name, **kw)
    assert (w.name, w.params()) == (jw.name, jw.params())
    fn, jfn = w.batcher(data[1], K), jw.batcher(data[0], K)
    for r, ids in ((0, np.arange(K)), (1, np.array([4, 1])), (5, np.array([2, 0, 5]))):
        got, want = fn(r, ids), jax.device_get(jfn(r, ids))
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=f"{name} r{r} {k}")
    if name == "quantity-skew":
        assert_same(w.pool_sizes(3, K), jw.pool_sizes(3, K))
    if name == "length-skew":
        assert_same(w.length_fracs(3, K), jw.length_fracs(3, K))
    if name == "dirichlet":
        assert_same(w.client_shards(3, K), jw.client_shards(3, K))


def test_workload_registry_and_errors_match_reference():
    assert workloads.workloads.names() == jax_workloads.workloads.names()
    inst = workloads.LengthSkewWorkload()
    assert workloads.get_workload(inst) is inst
    with pytest.raises(TypeError):
        workloads.get_workload(inst, min_frac=0.5)
    with pytest.raises(KeyError, match="known"):
        workloads.get_workload("zipf")
    with pytest.raises(ValueError, match="min_frac"):
        workloads.LengthSkewWorkload(min_frac=0.0)
    with pytest.raises(ValueError, match="cannot cover"):
        workloads.DirichletDomainWorkload(num_domains=2, domain_pool=2).client_shards(0, 5)


def test_dirichlet_domain_streams_keep_the_streams_device():
    """Domain streams are the client's stream with another seed and
    structure: a CPU ``TokenStream``'s domains draw on the CPU too."""
    stream = TokenStream(2, 8, 64, seed=3, device="cpu")
    w = workloads.get_workload("dirichlet", num_domains=3)
    doms = w.domain_streams(stream)
    assert [d.device for d in doms] == ["cpu"] * 3
    assert [d.seed for d in doms] == [3 + 9973 * (d + 1) for d in range(3)]
    np.testing.assert_allclose([d.structure for d in doms], np.linspace(0.55, 0.95, 3))
    batch = w.batcher(stream, 4)(0, np.arange(4))
    assert batch["tokens"].device.type == "cpu" and batch["tokens"].shape == (4, 2, 8)


# ---------------------------------------------------------------------------
# one async campaign that trains
# ---------------------------------------------------------------------------


def test_async_training_campaign_matches_reference(data):
    """Async (FedAsync, one arrival per aggregation, staleness-discounted
    weights and update scale) over a compact window of 2 of K = 4: the
    records bit for bit, metrics and the final adapters within 1e-4."""
    cfgs = run_configs(K=4)
    jexp, texp = pair(cfgs, schedule="async", population="compact", scenario="hetero")
    camp = dict(num_rounds=3, cohort=2, resample_channel=True)
    jres, tres = jexp.run(stream=data[0], **camp), texp.run(stream=data[1], **camp)
    assert_records_match(tres.records, jres.records)
    assert all(len(r.client_ids) == 2 for r in tres.records)
    assert any(r.staleness.max() > 0 for r in tres.records)
    assert lora_gap(tres.state, jres.state) <= ROUND
    assert texp.trace_count == jexp.trace_count == 1
