"""The port's queueing, network topologies and two-tier aggregation against
the reference.

``repro_torch.des.queueing`` and ``repro_torch.net`` are the reference's
numpy code: queue waits, per-hop timings (``HierRoundTiming``), attachments,
per-cell and wait-aware allocations and digests must equal the reference's
bit for bit (``assert_same``). The two-tier aggregation is torch: in the
port its batched fast path equals the unrolled per-edge oracle bit for bit
(M ≤ 32), and both sit within 1e-6 of the reference's (the scatter path at
M = 33 too); a two-tier smoke round matches the reference's within the
round tolerance of ``test_torch_train``, and in bfloat16 within the limits
of its bf16 round test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedsLLMConfig as JaxFedsLLMConfig
from repro.core import federated as jax_federated
from repro.core import fedsllm as JF
from repro.core import resource_alloc as jax_ra
from repro.des import queueing as jax_queueing
from repro.net import allocation as jax_allocation
from repro.net import delay as jax_delay
from repro.net import topology as jax_topology
from repro_torch import bridge
from repro_torch.api import aggregators, allocators
from repro_torch.config import FedsLLMConfig
from repro_torch.core import federated, fedsllm
from repro_torch.core import resource_alloc as ra
from repro_torch.des import queueing
from repro_torch.net import allocation, delay, topology
from repro_torch.sim import scenario
from repro_torch.tree import tree_leaves
from test_torch_alloc import assert_same, configs
from test_torch_train import (ETA, ROUND, _close, _close_lora, _flat,
                              _leaves_by_reference_order, _round_setup)

jax_aggregators = importlib.import_module("repro.api.aggregators")
jax_allocators = importlib.import_module("repro.api.allocators")
jax_scenario = importlib.import_module("repro.sim.scenario")

AGGREGATORS = ("fedavg", "weighted", "median", "trimmed_mean", "staleness")
GRID = np.array([0.3, 0.7])


# ---------------------------------------------------------------------------
# des/queueing.py
# ---------------------------------------------------------------------------

def _arrivals(n, seed, with_inf):
    rng = np.random.default_rng(seed)
    a = np.round(rng.uniform(0.0, 5.0, n), 1)  # rounded: ties happen
    if with_inf:
        a[rng.integers(0, n, 2)] = np.inf
    return a


@pytest.mark.parametrize("n,seed,with_inf", [(1, 0, False), (9, 1, False), (30, 2, True)])
def test_fifo_and_processor_sharing_bit_identical(n, seed, with_inf):
    arr = _arrivals(n, seed, with_inf)
    bits = np.random.default_rng(seed + 1).uniform(1e5, 1e7, n)
    for cap in (5e6, 0.0):
        assert_same(queueing.service_seconds(bits, cap), jax_queueing.service_seconds(bits, cap))
    service = queueing.service_seconds(bits, 5e6)
    assert_same(queueing.fifo(arr, service), jax_queueing.fifo(arr, service))
    assert_same(queueing.fifo(arr, 0.7), jax_queueing.fifo(arr, 0.7))
    for rate in (5e6, 1.0, 0.0):
        assert_same(queueing.processor_sharing(arr, bits, rate),
                    jax_queueing.processor_sharing(arr, bits, rate))
    assert_same(queueing.processor_sharing(np.zeros(0), np.zeros(0)),
                jax_queueing.processor_sharing(np.zeros(0), np.zeros(0)))


@pytest.mark.parametrize("lam,s", [(0.5, 0.2), (3.0, 0.3), (4.0, 0.25), (10.0, 0.5)])
def test_mean_waits_and_broadcast_bit_identical(lam, s):
    """The M/D/1 and PS means, also at and beyond saturation (ρ ≥ 1: inf)."""
    assert_same(queueing.md1_mean_wait(lam, s), jax_queueing.md1_mean_wait(lam, s))
    assert_same(queueing.ps_mean_wait(lam, s), jax_queueing.ps_mean_wait(lam, s))
    for cap in (2e7, 0.0):
        assert_same(queueing.broadcast_seconds(lam * 1e6, cap),
                    jax_queueing.broadcast_seconds(lam * 1e6, cap))


def test_simulated_fifo_and_ps_waits_near_their_means():
    """Poisson arrivals at ρ = 0.3: the simulated mean waits within 15% of
    the M/D/1 and M/D/1-PS formulas, in both packages alike."""
    rng = np.random.default_rng(0)
    lam, s, n = 3.0, 0.1, 20_000
    arr = np.cumsum(rng.exponential(1.0 / lam, n))
    _, wait = queueing.fifo(arr, s)
    assert_same(wait, jax_queueing.fifo(arr, s)[1])
    assert abs(np.mean(wait) / queueing.md1_mean_wait(lam, s) - 1.0) < 0.15
    done = queueing.processor_sharing(arr[:4000], np.full(4000, s))
    ps_wait = np.mean(done - arr[:4000] - s)
    assert abs(ps_wait / queueing.ps_mean_wait(lam, s) - 1.0) < 0.15


# ---------------------------------------------------------------------------
# net/delay.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_assign,with_downlink", [(True, False), (False, True), (True, True)])
def test_compose_bit_identical(with_assign, with_downlink):
    rng = np.random.default_rng(3)
    parts = [rng.uniform(0.1, 2.0, 5) for _ in range(3)]
    total = parts[0] + parts[1] + parts[2]
    hop = rng.uniform(0.0, 1.0, 5)
    assign = np.array([0, 1, 1, 0, 2]) if with_assign else None
    down = np.full(5, 0.25) if with_downlink else None
    got = delay.compose(fedsllm.RoundTiming(*parts, total), hop, assign, down)
    assert isinstance(got, fedsllm.RoundTiming)
    assert_same(got, jax_delay.compose(JF.RoundTiming(*parts, total), hop, assign, down))


# ---------------------------------------------------------------------------
# net/topology.py and net/allocation.py
# ---------------------------------------------------------------------------

TOPOLOGIES = [("star", {}), ("edge-cloud", {}), ("edge-agg", {}), ("relay", {}),
              ("edge-cloud", {"placement": "kmeans", "backhaul_model": "fifo"}),
              ("edge-agg", {"num_edges": 3, "backhaul_model": "ps", "downlink_bps": 5e7}),
              ("relay", {"placement": "kmeans", "backhaul_model": "ps", "backhaul_bps": 2e6}),
              ("edge-agg", {"num_edges": 7})]  # more edges than clients: empty cells
TOPO_IDS = [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}" for n, kw in TOPOLOGIES]
CLASSES = {"edge-cloud": "EdgeCloudTopology", "edge-agg": "EdgeAggTopology",
           "relay": "RelayTopology"}


def _topo_pair(name, kw):
    if not kw:
        return topology.get_topology(name), jax_topology.get_topology(name)
    return getattr(topology, CLASSES[name])(**kw), getattr(jax_topology, CLASSES[name])(**kw)


def _localized(name, kw, K=5, seed=2, sc="geo-blockfade"):
    """(topo, jtopo, cfg, jcfg, (net, assign), (jnet, jassign))."""
    t, jt = _topo_pair(name, kw)
    jcfg, cfg = configs(num_clients=K)
    net = scenario.get_scenario(sc).initial_network(cfg, seed)
    jnet = jax_scenario.get_scenario(sc).initial_network(jcfg, seed)
    return t, jt, cfg, jcfg, t.localize(cfg, net), jt.localize(jcfg, jnet)


def test_topology_registry_matches_reference():
    assert topology.topologies.names() == jax_topology.topologies.names()
    for name in topology.topologies.names():
        t, jt = topology.get_topology(name), jax_topology.get_topology(name)
        assert (t.name, t.num_edges, t.two_tier) == (jt.name, jt.num_edges, jt.two_tier)
        assert topology.get_topology(t) is t
    assert topology.get_topology("edge-agg").two_tier


@pytest.mark.parametrize("name,kw", TOPOLOGIES, ids=TOPO_IDS)
def test_localize_attach_and_digest_bit_identical(name, kw):
    t, jt, cfg, jcfg, (net, assign), (jnet, jassign) = _localized(name, kw)
    assert t.params() == jt.params()
    assert_same(net, jnet)
    assert_same(assign, jassign)
    if assign is not None:
        assert_same(t.edge_xy(cfg, net), jt.edge_xy(jcfg, jnet))
    for sc in ("geo-blockfade", "drift"):
        assert t.digest(cfg, scenario.get_scenario(sc), 4) == \
            jt.digest(jcfg, jax_scenario.get_scenario(sc), 4)


@pytest.mark.parametrize("name,kw", TOPOLOGIES, ids=TOPO_IDS)
def test_round_timing_and_cell_latency_bit_identical(name, kw):
    """Per-hop timing of one equal-bandwidth allocation: serial, FIFO and PS
    backhaul, a broadcast downlink, and an outage'd client (+inf uplink)."""
    t, jt, cfg, jcfg, (net, assign), (jnet, jassign) = _localized(name, kw)
    alloc = ra.solve_equal_bandwidth(cfg, net, 0.4)
    jalloc = jax_ra.solve_equal_bandwidth(jcfg, jnet, 0.4)
    for eta in (0.4, 0.8):
        assert_same(t.round_timing(cfg, net, alloc, eta, assign),
                    jt.round_timing(jcfg, jnet, jalloc, eta, jassign))
    if assign is None:
        return
    assert_same(allocation.cell_latency(cfg, net, alloc, assign, t, 0.4),
                jax_allocation.cell_latency(jcfg, jnet, jalloc, jassign, jt, 0.4))
    alloc.t_c[1] = jalloc.t_c[1] = np.inf
    got = t.round_timing(cfg, net, alloc, 0.4, assign)
    assert_same(got, jt.round_timing(jcfg, jnet, jalloc, 0.4, jassign))
    assert np.isinf(got.total[1]) and np.isfinite(np.delete(got.total, 1)).all()


# FE runs on the star only: on a graph with edges it takes BA's path through
# optimize_cells (η fixed at 0.1, one solve per cell), and its solver is
# held in test_torch_alloc
ALLOCATE_CASES = [(s, i) for i in (0, 2, 4, 5, 7) for s in ("EB", "FE", "BA", "proposed")
                  if (s, i) != ("proposed", 7) and (s != "FE" or i == 0)]


@pytest.mark.parametrize("strategy,name,kw", [(s,) + TOPOLOGIES[i] for s, i in ALLOCATE_CASES],
                         ids=[f"{TOPO_IDS[i]}-{s}" for s, i in ALLOCATE_CASES])
def test_allocate_bit_identical(name, kw, strategy, monkeypatch):
    """Every strategy on each graph, per cell on the hierarchical ones; on
    the queued graphs 'proposed' runs the wait-aware fixed point (its
    diagnostics equal too). The η sweep is cut to two points in both
    packages (``eta_grid_for``: the grid every sweep asks for); 'proposed'
    skips the graph with empty cells, which the others cover."""
    for mod in (ra, jax_ra):
        monkeypatch.setattr(mod, "eta_grid_for", lambda *a, **k: GRID)
    t, jt, cfg, jcfg, (net, assign), (jnet, jassign) = _localized(name, kw)
    got = t.allocate(cfg, net, assign, allocators.get_allocator(strategy), strategy=strategy)
    want = jt.allocate(jcfg, jnet, jassign, jax_allocators.get_allocator(strategy),
                       strategy=strategy)
    assert_same(got, want)
    assert got.feasible
    if hasattr(jt, "wait_diag"):
        assert_same(t.wait_diag, jt.wait_diag)
    eta = min(float(got.eta), cfg.eta_train_max)
    assert_same(t.round_timing(cfg, net, got, eta, assign),
                jt.round_timing(jcfg, jnet, want, eta, jassign))


def test_optimize_cells_coarse_and_wait_aware_pieces_bit_identical():
    """The coarse η sweep per cell, the expected backhaul hop, one wait-aware
    fixed point and the infeasible sentinel."""
    t, jt, cfg, jcfg, (net, assign), (jnet, jassign) = _localized(
        "edge-cloud", {"backhaul_model": "fifo", "backhaul_bps": 2e5}, K=4)
    got = allocation.optimize_cells(cfg, net, assign, t, allocators.get_allocator("EB"),
                                    strategy="EB", eta_search="coarse")
    assert_same(got, jax_allocation.optimize_cells(jcfg, jnet, jassign, jt,
                                                   jax_allocators.get_allocator("EB"),
                                                   strategy="EB", eta_search="coarse"))
    totals = fedsllm.simulate_round_time(cfg, net, got, 0.5).total
    assert_same(allocation.expected_backhaul_hop(cfg, net, assign, t, 0.5, totals),
                jax_allocation.expected_backhaul_hop(jcfg, jnet, jassign, jt, 0.5, totals))
    assert_same(allocation.solve_wait_aware(cfg, net, assign, t,
                                            allocators.get_allocator("proposed"), 0.6),
                jax_allocation.solve_wait_aware(jcfg, jnet, jassign, jt,
                                                jax_allocators.get_allocator("proposed"), 0.6))
    assert_same(allocation.subnetwork(net, np.array([0, 2])),
                jax_allocation.subnetwork(jnet, np.array([0, 2])))
    assert_same(allocation._infeasible(cfg, "EB"), jax_allocation._infeasible(jcfg, "EB"))


def test_hier_topologies_refuse_what_the_reference_refuses():
    jcfg, cfg = configs(num_clients=4)
    for mod, c in ((topology, cfg), (jax_topology, jcfg)):
        legacy = scenario.get_scenario("blockfade").initial_network(cfg, 0)
        with pytest.raises(ValueError, match="geometry"):
            mod.get_topology("edge-agg").localize(c, legacy)
        with pytest.raises(ValueError, match="kmeans"):
            mod.EdgeCloudTopology(placement="kmeans").edge_xy(c)
        for kw in ({"num_edges": 0}, {"backhaul_bps": 0.0}, {"placement": "grid"},
                   {"backhaul_model": "lifo"}, {"wait_iters": 0}, {"wait_damping": 0.0}):
            with pytest.raises(ValueError):
                mod.EdgeAggTopology(**kw)


# ---------------------------------------------------------------------------
# core/federated.py: hier_aggregate (torch)
# ---------------------------------------------------------------------------

def _hier_inputs(K, M, seed, empty_cell=False):
    """A LoRA-like stacked tree (fp32 and bf16 leaves), a one-hot (K, M)
    assignment, D_k-like weights and a survivor mask, in both libraries."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, M - 1 if empty_cell else M, K)
    assign = np.eye(M, dtype=np.float32)[edges]
    tree = {"a": rng.normal(size=(K, 4, 3)).astype(np.float32),
            "b": rng.normal(size=(K, 6)).astype(np.float32)}
    weights = rng.uniform(0.5, 2.0, K).astype(np.float32)
    mask = (rng.uniform(size=K) > 0.3).astype(np.float32)
    mask[0] = 1.0
    jtree = {"a": jnp.asarray(tree["a"]), "b": jnp.asarray(tree["b"]).astype(jnp.bfloat16)}
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": torch.from_numpy(tree["b"]).to(torch.bfloat16)}
    return ((ttree, torch.from_numpy(assign), torch.from_numpy(weights), torch.from_numpy(mask)),
            (jtree, jnp.asarray(assign), jnp.asarray(weights), jnp.asarray(mask)))


def _np32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("name", AGGREGATORS)
@pytest.mark.parametrize("K,M,empty_cell", [(7, 3, False), (6, 4, True), (5, 1, False),
                                            (40, 32, False), (48, 33, False), (9, 40, True)])
def test_hier_aggregate_matches_oracle_and_reference(name, K, M, empty_cell):
    """Fast path == unrolled oracle bit for bit in the port (M ≤ 32); fast
    path within 1e-6 of the reference's (of the largest value, per fp32
    leaf; one bf16 step per bf16 leaf) for all five aggregators, with and
    without weights and mask, with an empty cell, and past
    SEGMENT_MIN_EDGES (the scatter path) against the oracle too. Each leaf
    keeps its dtype. The wide cases (M ≥ 32: 32-40 aggregate calls a
    combination) run without and with both weights and mask; the narrow
    ones each alone too."""
    (t, a, w, m), (jt, ja, jw, jm) = _hier_inputs(K, M, seed=K + M, empty_cell=empty_cell)
    agg, jagg = aggregators.get_aggregator(name), jax_aggregators.get_aggregator(name)
    combos = [(None, None, None, None), (w, m, jw, jm)]
    if M < 32:
        combos += [(w, None, jw, None), (None, m, None, jm)]
    for tw, tm, jw_, jm_ in combos:
        fast = federated.hier_aggregate(agg, t, a, weights=tw, mask=tm)
        slow = federated.hier_aggregate_unrolled(agg, t, a, weights=tw, mask=tm)
        want = jax_federated.hier_aggregate(jagg, jt, ja, weights=jw_, mask=jm_)
        for leaf in t:
            assert fast[leaf].dtype == t[leaf].dtype and fast[leaf].shape == t[leaf].shape[1:]
            g, s, r = _np32(fast[leaf]), _np32(slow[leaf]), _np32(want[leaf])
            # bf16 leaves: one bf16 step of the largest value, where the
            # fp32 sums the two libraries round differ in their last bit
            tol = 1e-6 if t[leaf].dtype == torch.float32 else 2.0 ** -7
            scale = max(np.abs(r).max(), 1e-30)
            assert np.abs(g - r).max() <= tol * scale, (name, leaf, np.abs(g - r).max())
            if M <= federated.SEGMENT_MIN_EDGES:
                np.testing.assert_array_equal(g, s)
            else:
                assert np.abs(g - s).max() <= tol * scale


def test_mean_family_markers_match_reference():
    """The port's aggregators carry the reference's ``mean_family`` markers,
    on which hier_aggregate dispatches."""
    for name in AGGREGATORS:
        assert getattr(aggregators.get_aggregator(name), "mean_family", None) == \
            getattr(jax_aggregators.get_aggregator(name), "mean_family", None), name
    assert federated.fedavg.mean_family == jax_federated.fedavg.mean_family == "weighted"
    assert federated.staleness_weighted.mean_family == "weighted"
    assert federated._strip_mean_family(federated.fedavg).__dict__ == {}
    assert federated.SEGMENT_MIN_EDGES == jax_federated.SEGMENT_MIN_EDGES


def test_fedavg_and_apply_update_round_once_like_the_reference():
    """The weighted sums and the update are fused multiply-adds (one rounding
    each), bit for bit with the reference compiled on the CPU."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 257)).astype(np.float32)
    w = rng.uniform(0.1, 3.0, 6).astype(np.float32)
    got = federated.fedavg({"x": torch.from_numpy(x)}, weights=torch.from_numpy(w))["x"]
    want = jax.jit(jax_federated.fedavg)({"x": jnp.asarray(x)}, weights=jnp.asarray(w))["x"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    base = rng.normal(size=257).astype(np.float32)
    got = federated.apply_update({"x": torch.from_numpy(base)}, {"x": torch.from_numpy(x[0])},
                                 torch.tensor(0.3))["x"]
    want = jax.jit(jax_federated.apply_update)({"x": jnp.asarray(base)},
                                               {"x": jnp.asarray(x[0])}, jnp.float32(0.3))["x"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# core/fedsllm.py: two_tier=True (torch)
# ---------------------------------------------------------------------------

ASSIGN = np.eye(2, dtype=np.float32)[[0, 1, 0]]


@pytest.fixture(scope="module")
def two_tier_setup():
    return _round_setup()


@pytest.mark.parametrize("name", ["weighted", "median"])
def test_two_tier_round_matches_reference(two_tier_setup, name):
    """One smoke round through the two-tier aggregation (client 1 alone on
    its edge, client 2 masked out, D_k weights) against the reference's,
    within the round tolerance; the mean family's batched path and the
    median's unrolled one."""
    s = two_tier_setup
    fn = fedsllm.build_round_fn(s["cfg"], FedsLLMConfig(num_clients=3), 1, ETA,
                                aggregator=aggregators.get_aggregator(name), two_tier=True)
    jfn = jax.jit(JF.build_round_fn(s["jcfg"], JaxFedsLLMConfig(num_clients=3), 1, ETA,
                                    aggregator=jax_aggregators.get_aggregator(name),
                                    two_tier=True))
    mask, weights = (1.0, 1.0, 0.0), (3.0, 1.0, 2.0)
    state, m = fn(s["state"], s["batches"][0], torch.tensor(mask), None, torch.tensor(weights),
                  torch.from_numpy(ASSIGN))
    jstate, jm = jfn(s["jstate"], s["jbatches"][0], jnp.asarray(mask), None, jnp.asarray(weights),
                     jnp.asarray(ASSIGN))
    for k in jm:
        _close(m[k], jm[k], ROUND, f"two-tier {name} {k}")
    _close_lora(state.lora_c, jstate.lora_c, ROUND, f"two-tier {name} lora_c")
    _close_lora(state.lora_s, jstate.lora_s, ROUND, f"two-tier {name} lora_s")


def test_two_tier_without_assign_is_the_flat_round(two_tier_setup):
    """``two_tier=True`` with ``assign=None`` aggregates flat, as the
    reference does: bit for bit the round built without two_tier."""
    s = two_tier_setup
    outs = []
    for two_tier in (True, False):
        fn = fedsllm.build_round_fn(s["cfg"], FedsLLMConfig(num_clients=3), 1, ETA,
                                    two_tier=two_tier)
        outs.append(fn(s["state"], s["batches"][0], weights=torch.tensor([3.0, 1.0, 2.0])))
    (a, ma), (b, mb) = outs
    for x, y in zip(tree_leaves((a.lora_c, a.lora_s, ma)), tree_leaves((b.lora_c, b.lora_s, mb))):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_two_tier_weighted_equals_flat_up_to_associativity(two_tier_setup):
    """For the weighted mean, per edge then across edges equals the flat
    average up to fp32 associativity: ḡ and h̄ each differ in their last
    bits, carried through the local steps, so within 1e-5 of the largest
    value per leaf (1.5e-6 measured when written)."""
    s = two_tier_setup
    fn = fedsllm.build_round_fn(s["cfg"], FedsLLMConfig(num_clients=3), 1, ETA,
                                aggregator=aggregators.get_aggregator("weighted"), two_tier=True)
    w = torch.tensor([3.0, 1.0, 2.0])
    two, _ = fn(s["state"], s["batches"][0], weights=w, assign=torch.from_numpy(ASSIGN))
    flat, _ = fn(s["state"], s["batches"][0], weights=w)
    for x, y in zip(tree_leaves((two.lora_c, two.lora_s)), tree_leaves((flat.lora_c, flat.lora_s))):
        assert (x - y).abs().max() <= 1e-5 * y.abs().max()


@pytest.fixture(scope="module")
def two_tier_setup_bf16(two_tier_setup):  # built after the fp32 one, which warms JAX up
    return _round_setup("bfloat16")


def _leaf_gaps(got, want):
    """Relative Frobenius distance of each pair of leaves (fp32 arrays)."""
    return [np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30) for g, w in zip(got, want)]


def test_two_tier_round_bf16_matches_reference(two_tier_setup_bf16):
    """The bfloat16 two-tier round (weighted, D_k weights, client 1 alone on
    its edge), from a state one flat round in (B ≠ 0), against the
    reference's: the losses within 1e-4 and each side's aggregated update
    h̄ within 0.1 relative Frobenius, the limits of
    ``test_round_fn_bf16_matches_reference`` (3.3e-2 / 3.4e-2 measured when
    written). And in bfloat16 two-tier does not equal flat to 2^-8 in
    either library: the ulp-level differences of ḡ and h̄ between the two
    reductions move the bf16 local steps. The reference's own two-tier
    round departs from its flat round by 2.2e-2 / 2.1e-2 per adapter leaf
    at most (the port's 2.2e-2 / 2.0e-2; reordering the clients of the
    reference's flat sum alone moves its adapters by 1e-2, all measured when
    written); the port's departure may be at most twice the reference's."""
    s = two_tier_setup_bf16
    agg, jagg = aggregators.get_aggregator("weighted"), jax_aggregators.get_aggregator("weighted")
    fns = {t: fedsllm.build_round_fn(s["cfg"], FedsLLMConfig(num_clients=3), 1, ETA,
                                     aggregator=agg, two_tier=t) for t in (True, False)}
    jfns = {t: jax.jit(JF.build_round_fn(s["jcfg"], JaxFedsLLMConfig(num_clients=3), 1, ETA,
                                         aggregator=jagg, two_tier=t)) for t in (True, False)}
    weights = (3.0, 1.0, 2.0)
    jw, tw, jones = jnp.asarray(weights), torch.tensor(weights), jnp.ones(3, jnp.float32)
    jstart, _ = jfns[False](s["jstate"], s["jbatches"][0], jones, None, jw, None)
    start = bridge.state_from_numpy(*jax.device_get(tuple(jstart)), device="cpu")
    jb, b = s["jbatches"][1], s["batches"][1]
    jtwo, jm = jfns[True](jstart, jb, jones, None, jw, jnp.asarray(ASSIGN))
    jflat, _ = jfns[False](jstart, jb, jones, None, jw, None)
    rev = jnp.arange(2, -1, -1)  # the flat sum over the clients in reverse order
    jrev, _ = jfns[False](jstart, jax.tree.map(lambda x: x[rev], jb), jones, None, jw[rev], None)
    two, m = fns[True](start, b, torch.ones(3), None, tw, torch.from_numpy(ASSIGN))
    flat, _ = fns[False](start, b, torch.ones(3), None, tw)
    for k in ("loss_round_start", "loss_local_final"):
        _close(m[k], jm[k], 1e-4, f"two-tier bf16 {k}")
    for side in ("lora_c", "lora_s"):
        port = {n: getattr(st, side) for n, st in (("two", two), ("flat", flat),
                                                   ("start", start))}
        ref = {n: getattr(st, side) for n, st in (("two", jtwo), ("flat", jflat),
                                                  ("rev", jrev), ("start", jstart))}
        hbar = _flat(port["two"]) - _flat(port["start"])
        jhbar = _flat(ref["two"], reference=True) - _flat(ref["start"], reference=True)
        gap = np.linalg.norm(hbar - jhbar) / np.linalg.norm(jhbar)
        assert gap <= 0.1, f"two-tier bf16 h̄ {side}: {gap:.3e}"
        leaves = {n: [np.asarray(x.float().numpy()) for x in
                      _leaves_by_reference_order(t, tree_leaves(t))] for n, t in port.items()}
        jleaves = {n: [np.asarray(x, np.float32) for x in jax.tree.leaves(t)]
                   for n, t in ref.items()}
        own, jown = (max(_leaf_gaps(x["two"], x["flat"])) for x in (leaves, jleaves))
        jreorder = max(_leaf_gaps(jleaves["rev"], jleaves["flat"]))
        print(f"{side}: two-tier vs flat per leaf, port {own:.3e}, reference {jown:.3e}; "
              f"reference reordered vs flat {jreorder:.3e}; h̄ port vs reference {gap:.3e}")
        assert own <= 2.0 * jown, f"two-tier vs flat {side}: port {own:.3e}, reference {jown:.3e}"
