"""The port's channel scenarios and per-round events against the reference.

``repro_torch.sim.scenario`` and ``repro_torch.sim.events`` are the
reference's numpy code: for the same ``FedsLLMConfig`` and seeds, every
scenario's large-scale state, initial network and per-round networks, its
digest string, and every event helper (round seeds, cohorts, straggler
masks, the retimed stale allocation, topology-localized draws) must equal
the reference's bit for bit.
"""

import importlib

import numpy as np
import pytest

from repro.core import resource_alloc as jax_ra
from repro.net import topology as jax_topology
from repro_torch.core import resource_alloc as ra
from repro_torch.net import topology
from repro_torch.sim import events, scenario
from test_torch_alloc import assert_same, configs

jax_scenario = importlib.import_module("repro.sim.scenario")
jax_events = importlib.import_module("repro.sim.events")

NAMES = ("frozen", "blockfade", "geo-blockfade", "drift", "hetero", "outage", "shadowing")
# parameterised variants, built the same way in both packages
VARIANTS = [("DriftScenario", {"step_m": 55.0}),
            ("HeteroScenario", {"f_tiers_hz": (1e9, 3e9), "p_tiers_dbm": (0.0, 20.0)}),
            ("OutageScenario", {"prob": 0.6, "depth_db": 10.0, "burst_rounds": 2}),
            ("ShadowingScenario", {"rho": 0.35})]


def _pair(spec, kw=None):
    """(port scenario, reference scenario) by name or class name + kwargs."""
    if kw is None:
        return scenario.get_scenario(spec), jax_scenario.get_scenario(spec)
    return getattr(scenario, spec)(**kw), getattr(jax_scenario, spec)(**kw)


def test_scenario_registry_matches_reference():
    assert scenario.scenarios.names() == jax_scenario.scenarios.names() == sorted(NAMES)
    for name in NAMES:
        sc = scenario.get_scenario(name)
        assert sc.name == name and scenario.get_scenario(sc) is sc
    assert isinstance(scenario.get_scenario(scenario.DriftScenario), scenario.DriftScenario)


@pytest.mark.parametrize("spec,kw", [(n, None) for n in NAMES] + VARIANTS,
                         ids=list(NAMES) + [v[0] for v in VARIANTS])
@pytest.mark.parametrize("K,seed", [(6, 0), (11, 23)])
def test_scenario_networks_and_digest_bit_identical(spec, kw, K, seed):
    """Large-scale state, initial network, rounds 0-4 and the digest."""
    sc, jsc = _pair(spec, kw)
    jcfg, cfg = configs(num_clients=K)
    assert sc.params() == jsc.params()
    assert_same(sc.large_scale(cfg, seed), jsc.large_scale(jcfg, seed))
    assert_same(sc.initial_network(cfg, seed), jsc.initial_network(jcfg, seed))
    for r in range(5):
        assert_same(sc.round_large_scale(cfg, seed, r), jsc.round_large_scale(jcfg, seed, r))
        assert_same(sc.round_network(cfg, seed, r), jsc.round_network(jcfg, seed, r))
    assert sc.digest(cfg, seed) == jsc.digest(jcfg, seed)


def test_scenario_extra_fields_bit_identical():
    """The outage penalty and the AR(1) shadow field, windows and rounds apart."""
    jcfg, cfg = configs(num_clients=7)
    out, jout = _pair("outage")
    sh, jsh = _pair("shadowing")
    for r in (0, 2, 3, 9):
        assert_same(out.extra_loss_db(cfg, 4, r), jout.extra_loss_db(jcfg, 4, r))
        assert_same(sh.shadow_db(cfg, 4, r), jsh.shadow_db(jcfg, 4, r))


def test_scenario_parameter_validation_matches_reference():
    bad = [("HeteroScenario", {"f_tiers_hz": (1e9,), "p_tiers_dbm": (1.0, 2.0)}),
           ("OutageScenario", {"prob": 1.5}), ("OutageScenario", {"burst_rounds": 0}),
           ("ShadowingScenario", {"rho": 1.0})]
    for cls, kw in bad:
        for mod in (scenario, jax_scenario):
            with pytest.raises(ValueError):
                getattr(mod, cls)(**kw)


def test_base_large_scale_is_cached_per_config_and_seed():
    _, cfg = configs(num_clients=5)
    assert scenario._base_large_scale(cfg, 3) is scenario._base_large_scale(cfg, 3)
    assert scenario._base_large_scale(cfg, 3) is not scenario._base_large_scale(cfg, 4)


@pytest.mark.parametrize("campaign_seed,round_idx", [(0, 0), (3, 7), (12345, 2)])
def test_round_seed_and_round_network_bit_identical(campaign_seed, round_idx):
    jcfg, cfg = configs(num_clients=6)
    assert events.round_seed(campaign_seed, round_idx) == \
        jax_events.round_seed(campaign_seed, round_idx)
    assert_same(events.round_network(cfg, campaign_seed, round_idx),
                jax_events.round_network(jcfg, campaign_seed, round_idx))
    sc, jsc = _pair("drift")
    assert_same(events.round_network(cfg, campaign_seed, round_idx, scenario=sc),
                jax_events.round_network(jcfg, campaign_seed, round_idx, scenario=jsc))


@pytest.mark.parametrize("topo", [None, "star", "edge-cloud", "edge-agg", "relay"])
def test_localized_round_network_bit_identical(topo):
    jcfg, cfg = configs(num_clients=8)
    sc, jsc = _pair("drift")
    t = None if topo is None else topology.get_topology(topo)
    jt = None if topo is None else jax_topology.get_topology(topo)
    for r in (0, 3):
        assert_same(events.localized_round_network(cfg, 5, r, scenario=sc, topology=t),
                    jax_events.localized_round_network(jcfg, 5, r, scenario=jsc, topology=jt))


def test_retime_allocation_bit_identical():
    """A stale allocation re-priced on later rounds' gains; a zero bandwidth
    is an outage (+inf uplink)."""
    jcfg, cfg = configs(num_clients=5)
    sc, jsc = _pair("geo-blockfade")
    grid = np.array([0.4])
    alloc = ra.optimize(cfg, sc.initial_network(cfg, 1), "proposed", eta_grid=grid)
    jalloc = jax_ra.optimize(jcfg, jsc.initial_network(jcfg, 1), "proposed", eta_grid=grid)
    assert_same(alloc, jalloc)
    for r in (0, 4):
        assert_same(events.retime_allocation(cfg, sc.round_network(cfg, 1, r), alloc),
                    jax_events.retime_allocation(jcfg, jsc.round_network(jcfg, 1, r), jalloc))
    alloc.b_c[2] = jalloc.b_c[2] = 0.0
    got = events.retime_allocation(cfg, sc.round_network(cfg, 1, 2), alloc)
    assert_same(got, jax_events.retime_allocation(jcfg, jsc.round_network(jcfg, 1, 2), jalloc))
    assert np.isinf(got.t_c[2])


@pytest.mark.parametrize("num_clients,cohort,seed", [(10, 4, 0), (10, 10, 1), (200, 9, 3)])
def test_cohorts_masks_and_wall_clock_bit_identical(num_clients, cohort, seed):
    totals = np.random.default_rng(seed).uniform(1.0, 9.0, num_clients)
    for r in range(3):
        ids = events.cohort_ids(r, num_clients, cohort, seed=seed)
        assert_same(ids, jax_events.cohort_ids(r, num_clients, cohort, seed=seed))
        for deadline in (None, 5.0, 0.5):
            assert_same(events.straggler_mask(totals, ids, deadline),
                        jax_events.straggler_mask(totals, ids, deadline))
            assert_same(events.round_wall_clock(totals, ids, deadline),
                        jax_events.round_wall_clock(totals, ids, deadline))


def test_events_constants_match_reference():
    for name in ("ROUND_SEED_STRIDE", "COHORT_STREAM_TAG", "CHANNEL_STREAM_TAG"):
        assert getattr(events, name) == getattr(jax_events, name)
    for name in ("DRIFT_STREAM_TAG", "HETERO_STREAM_TAG", "OUTAGE_STREAM_TAG",
                 "SHADOW_STREAM_TAG"):
        assert getattr(scenario, name) == getattr(jax_scenario, name)
