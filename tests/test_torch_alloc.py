"""The port's §IV allocation and round timing against the reference.

``repro_torch.core.resource_alloc``, ``repro_torch.api.allocators`` and the
simulated round wall-clock of ``repro_torch.core.fedsllm`` are the
reference's numpy/scipy code: the same ``FedsLLMConfig`` values and seeds go
to both packages and every array and field must come out bit for bit equal
(``assert_same``; NaN equals NaN). Solves are kept short: an explicit
``eta_grid`` of 2-3 points everywhere but one ``eta_search="coarse"`` case
at K = 3 (~20 s a package on a CPU, whatever K).
"""

import dataclasses
import importlib

import numpy as np
import pytest

from repro.config import FedsLLMConfig as JaxFedsLLMConfig
from repro.core import delay_model as jax_dm
from repro.core import fedsllm as jax_fedsllm
from repro.core import resource_alloc as jax_ra
allocators = importlib.import_module("repro_torch.api.allocators")  # the package exports a Registry
from repro_torch.config import FedsLLMConfig
from repro_torch.core import delay_model as dm
from repro_torch.core import fedsllm
from repro_torch.core import resource_alloc as ra

jax_allocators = importlib.import_module("repro.api.allocators")  # the package exports a Registry

GRID = np.array([0.3, 0.7])
STRATEGIES = ("proposed", "EB", "FE", "BA")


def assert_same(got, want, path="value"):
    """``got`` equals ``want`` bit for bit: dataclasses field by field (and of
    the same class name), arrays and numbers with their dtypes, NaN = NaN."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif want is None or isinstance(want, str):
        assert got == want, f"{path}: {got!r} != {want!r}"
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape)
        assert np.array_equal(g, w, equal_nan=g.dtype.kind in "fc"), f"{path}: {g} != {w}"


def configs(**kw):
    """The same FedsLLMConfig in both packages: (reference, port)."""
    return JaxFedsLLMConfig(**kw), FedsLLMConfig(**kw)


def networks(K, seed, **kw):
    """(jcfg, jnet, cfg, net): the legacy §IV draw in each package."""
    jcfg, cfg = configs(num_clients=K)
    return (jcfg, jax_dm.sample_network(jcfg, seed=seed, **kw),
            cfg, dm.sample_network(cfg, seed=seed, **kw))


@pytest.mark.parametrize("K,seed,lmbda", [(4, 0, 0.3), (7, 5, 0.8)])
def test_split_costs_and_best_split_bit_identical(K, seed, lmbda):
    jcfg, jnet, cfg, net = networks(K, seed)
    R = np.random.default_rng(seed).uniform(0.5, 5.0, K)
    V = dm.local_iters(cfg, 0.4)
    theta = ra._best_split(lmbda, R, V, cfg.s_c_bits, cfg.s_bits, net)
    assert_same(theta, jax_ra._best_split(lmbda, R, V, jcfg.s_c_bits, jcfg.s_bits, jnet))
    assert_same(ra._split_costs(theta, R, V, cfg.s_c_bits, cfg.s_bits, net),
                jax_ra._split_costs(theta, R, V, jcfg.s_c_bits, jcfg.s_bits, jnet))


@pytest.mark.parametrize("T,extra", [(3e4, None), (8e4, None), (8e4, 2.0), (10.0, None)])
def test_feasibility_bit_identical(T, extra):
    """Inside and outside the feasible region, with and without a committed
    extra delay (T = 10 s leaves no budget: inf, None)."""
    jcfg, jnet, cfg, net = networks(5, 1)
    ed = None if extra is None else np.full(5, extra)
    assert_same(ra._feasibility(T, cfg, net, 0.3, cfg.split_ratio_min, None, extra_delay=ed),
                jax_ra._feasibility(T, jcfg, jnet, 0.3, jcfg.split_ratio_min, None,
                                    extra_delay=ed))


@pytest.mark.parametrize("K,seed,eta,A,extra", [(4, 0, 0.1, None, None), (6, 3, 0.55, 0.3, None),
                                                (5, 2, 0.9, None, 1.5), (3, 7, 0.3, None, 1e20)])
def test_solve_fixed_eta_exact_bit_identical(K, seed, eta, A, extra):
    """Lemma-3 exact solver; the last case's extra delay makes it infeasible."""
    jcfg, jnet, cfg, net = networks(K, seed)
    ed = None if extra is None else np.full(K, extra)
    got = ra.solve_fixed_eta_exact(cfg, net, eta, A=A, extra_delay=ed)
    assert_same(got, jax_ra.solve_fixed_eta_exact(jcfg, jnet, eta, A=A, extra_delay=ed))
    assert got.feasible == (extra != 1e20)


@pytest.mark.parametrize("K,seed,eta,params", [(4, 0, 0.1, None), (9, 4, 0.7, 2_000_000)])
def test_solve_equal_bandwidth_bit_identical(K, seed, eta, params):
    jcfg, jnet, cfg, net = networks(K, seed)
    assert_same(ra.solve_equal_bandwidth(cfg, net, eta, model_params=params),
                jax_ra.solve_equal_bandwidth(jcfg, jnet, eta, model_params=params))


def test_solve_fixed_eta_scipy_bit_identical():
    """The fmincon-equivalent SLSQP program (scipy), the paper-faithful route."""
    jcfg, jnet, cfg, net = networks(3, 0)
    got = ra.solve_fixed_eta_scipy(cfg, net, 0.5)
    assert_same(got, jax_ra.solve_fixed_eta_scipy(jcfg, jnet, 0.5))
    assert got.strategy == "scipy"


@pytest.mark.parametrize("eta,bucket,eta_max", [(0.37, 0.05, 0.5), (0.99, 0.05, 0.5),
                                                (0.01, 0.05, 0.5), (0.62, 0.1, 0.9)])
def test_quantize_eta_bit_identical(eta, bucket, eta_max):
    assert_same(ra.quantize_eta(eta, bucket, eta_max), jax_ra.quantize_eta(eta, bucket, eta_max))


def test_quantize_eta_and_warm_grid_refuse_bad_input():
    for mod in (ra, jax_ra):
        with pytest.raises(ValueError, match="positive"):
            mod.quantize_eta(0.3, bucket=0.0)
    for mod, cfg in zip((ra, jax_ra), configs()[::-1]):
        with pytest.raises(ValueError, match="eta0"):
            mod.eta_grid_for(cfg, "warm")


@pytest.mark.parametrize("search,eta0", [("grid", None), ("coarse", None), ("warm", 0.42),
                                         ("warm", 0.02), ("warm", 0.97)])
def test_eta_grids_bit_identical(search, eta0):
    jcfg, cfg = configs()
    assert_same(ra.eta_grid_for(cfg, search, eta0), jax_ra.eta_grid_for(jcfg, search, eta0))
    if eta0 is not None:
        assert_same(ra.eta_refine_grid(cfg, eta0), jax_ra.eta_refine_grid(jcfg, eta0))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("K,seed", [(4, 0), (8, 3)])
def test_optimize_bit_identical(strategy, K, seed):
    """Every strategy of ``optimize`` on a short η grid."""
    jcfg, jnet, cfg, net = networks(K, seed)
    got = ra.optimize(cfg, net, strategy, eta_grid=GRID)
    assert_same(got, jax_ra.optimize(jcfg, jnet, strategy, eta_grid=GRID))
    assert got.feasible


def test_optimize_proposed_coarse_bit_identical():
    """The one 'coarse' sweep (0.05 steps, then a 0.01-step refinement)."""
    jcfg, jnet, cfg, net = networks(3, 2)
    got = ra.optimize(cfg, net, "proposed", eta_search="coarse")
    assert_same(got, jax_ra.optimize(jcfg, jnet, "proposed", eta_search="coarse"))


def test_optimize_scipy_solver_and_extra_delay_bit_identical():
    jcfg, jnet, cfg, net = networks(3, 1)
    grid = np.array([0.3, 0.6])
    assert_same(ra.optimize(cfg, net, "FE", solver="scipy"),
                jax_ra.optimize(jcfg, jnet, "FE", solver="scipy"))
    ed = np.array([0.5, 0.0, 2.0])
    assert_same(ra.optimize(cfg, net, "proposed", eta_grid=grid, extra_delay=ed),
                jax_ra.optimize(jcfg, jnet, "proposed", eta_grid=grid, extra_delay=ed))
    for mod, c, n in ((ra, cfg, net), (jax_ra, jcfg, jnet)):
        with pytest.raises(ValueError):
            mod.optimize(c, n, "nonsense")


def test_allocator_registry_matches_reference():
    assert allocators.allocators.names() == jax_allocators.allocators.names()
    jcfg, jnet, cfg, net = networks(4, 6)
    for name in STRATEGIES:
        assert_same(allocators.get_allocator(name)(cfg, net, eta_grid=GRID),
                    jax_allocators.get_allocator(name)(jcfg, jnet, eta_grid=GRID))


def _fig2(alloc_mod, dm_mod, cfg, powers, grid):
    """The Fig. 2 experiment of ``benchmarks/fig2_delay.py`` (latency of each
    strategy against the maximum transmit power), on a short η grid."""
    rows = []
    for p in powers:
        net = dm_mod.sample_network(cfg, seed=0, p_max_dbm=p)
        rows.append({s: alloc_mod.get_allocator(s)(cfg, net, eta_grid=grid).T
                     for s in STRATEGIES})
    return rows, float(np.mean([1 - r["proposed"] / r["BA"] for r in rows]))


def test_fig2_reduced_bit_identical():
    """Fig. 2 at K = 5, powers 0 and 20 dBm: per-strategy latencies and the
    average reduction against BA (the paper's 47.63% claim at K = 50) equal."""
    jcfg, cfg = configs(num_clients=5)
    grid = np.array([0.3, 0.6, 0.9])
    rows, red = _fig2(allocators, dm, cfg, (0.0, 20.0), grid)
    jrows, jred = _fig2(jax_allocators, jax_dm, jcfg, (0.0, 20.0), grid)
    assert_same(rows, jrows)
    assert_same(red, jred)
    assert 0.0 < red < 1.0
    assert all(r["proposed"] <= min(r["EB"], r["FE"], r["BA"]) for r in rows)


@pytest.mark.parametrize("strategy,eta,params", [("proposed", 0.5, None), ("BA", 0.1, None),
                                                 ("EB", 0.35, 3_000_000)])
def test_round_timing_bit_identical(strategy, eta, params):
    """``simulate_round_time`` (eq. 10 compute + t_c + V·t_s) on an allocation."""
    jcfg, jnet, cfg, net = networks(5, 4)
    alloc = ra.optimize(cfg, net, strategy, eta_grid=GRID)
    jalloc = jax_ra.optimize(jcfg, jnet, strategy, eta_grid=GRID)
    got = fedsllm.simulate_round_time(cfg, net, alloc, eta, model_params=params)
    assert isinstance(got, fedsllm.RoundTiming)
    assert_same(got, jax_fedsllm.simulate_round_time(jcfg, jnet, jalloc, eta, model_params=params))
    np.testing.assert_array_equal(got.total, got.compute + got.uplink_fed + got.uplink_main)


def test_round_timing_is_a_dataclass_like_the_reference():
    fields = lambda cls: [f.name for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(fedsllm.RoundTiming) == fields(jax_fedsllm.RoundTiming)
    t = fedsllm.RoundTiming(*(np.zeros(2) for _ in range(4)))
    assert_same(t, jax_fedsllm.RoundTiming(*(np.zeros(2) for _ in range(4))))
