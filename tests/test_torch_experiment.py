"""The port's ``Experiment`` facade, campaign engine and checkpointer against
the reference, run live.

Both experiments are built from the same ``RunConfig`` and seed; the port's
weights are then set from the reference's (``bridge.state_from_numpy``; a
scaffold experiment carries its variates too), since ``jax.random`` cannot be
reproduced in torch. Both read the same numpy batches: a numpy stream
(``NumpyStream``) wrapped for each package. Every host-side number (networks,
allocations, η, timings, cohorts, masks, schedule plans and events, records
of simulated time) must be bit-identical; losses and adapters of the fp32
smoke model within 1e-4 of the largest value, the round tolerance of
``tests/test_torch_train.py``. The training η is clamped at 0.9, so each
round runs I_loc = 2 local steps, as the round tests do. Within the port,
``run(num_rounds=1, …)`` equals ``run_round`` and a resumed campaign the
uninterrupted one, bit for bit.

Every experiment here prices with ``allocator="EB"`` (or is handed its
network and allocation): a ``proposed`` solve takes tens of seconds on the
CPU, and its arithmetic is held to the reference in ``test_torch_alloc.py``.
"""

import dataclasses
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Experiment as JaxExperiment
from repro.config import FedsLLMConfig as JaxFedsLLMConfig
from repro.config import LoRAConfig as JaxLoRAConfig
from repro.config import RunConfig as JaxRunConfig
from repro.config import SHAPES as JAX_SHAPES
from repro.config import get_arch as jax_get_arch
from repro.config import smoke_variant as jax_smoke_variant
from repro_torch import bridge
from repro_torch.api import (CampaignResult, Experiment, RoundRecord, RoundResult,
                             get_compressor)
from repro_torch.checkpoint import Checkpointer
from repro_torch.config import SHAPES, FedsLLMConfig, LoRAConfig, RunConfig, get_arch, smoke_variant
from repro_torch.core import fedsllm
from repro_torch.sim import events
from repro_torch.tree import tree_leaves, tree_map
from test_torch_alloc import assert_same

jax_api = importlib.import_module("repro.api")
torch_api = importlib.import_module("repro_torch.api")

K = 4
B, S = 2, 16
ETA_MAX = 0.9  # the training η's clamp: I_loc = 2
ROUND = 1e-4
AXES = ("aggregators", "allocators", "compressors", "scenarios", "topologies", "schedules",
        "local_algos", "workloads", "populations")


# ---------------------------------------------------------------------------
# shared with test_torch_des.py and test_torch_sweep.py
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NumpyStream:
    """A learnable bigram stream drawn with numpy from (seed, step): the same
    batches for both packages. Fields as ``TokenStream``'s, so the workloads
    can derive domain streams from it."""

    batch: int
    seq: int
    vocab: int
    seed: int = 0
    structure: float = 0.8

    def numpy_batch(self, step: int) -> dict:
        rng = np.random.default_rng([self.seed, step])
        perm = np.random.default_rng(1234).permutation(self.vocab)
        toks = [rng.integers(0, self.vocab, self.batch)]
        for _ in range(self.seq - 1):
            det = rng.random(self.batch) < self.structure
            toks.append(np.where(det, perm[toks[-1]], rng.integers(0, self.vocab, self.batch)))
        tokens = np.stack(toks, axis=1).astype(np.int32)
        return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
                "mask": np.ones(tokens.shape, np.float32)}


@dataclasses.dataclass
class JaxStream(NumpyStream):
    def batch_at(self, step: int):
        return {k: jnp.asarray(v) for k, v in self.numpy_batch(step).items()}


@dataclasses.dataclass
class TorchStream(NumpyStream):
    device: str = "cpu"

    def batch_at(self, step: int):
        return bridge.batches_from_numpy(self.numpy_batch(step), device=self.device)


def streams(vocab, batch=B, seq=S, seed=0):
    return JaxStream(batch, seq, vocab, seed), TorchStream(batch, seq, vocab, seed)


def run_configs(K=K, **fkw):
    """(reference, port) RunConfig of the smoke fedsllm-100m (fp32, rank 4)."""
    jcfg = jax_smoke_variant(jax_get_arch("fedsllm-100m")).replace(
        lora=JaxLoRAConfig(rank=4, alpha=8.0))
    cfg = smoke_variant(get_arch("fedsllm-100m")).replace(lora=LoRAConfig(rank=4, alpha=8.0))
    fkw = dict(num_clients=K, eta_train_max=ETA_MAX, **fkw)
    return (JaxRunConfig(model=jcfg, shape=JAX_SHAPES["train_4k"],
                         fedsllm=JaxFedsLLMConfig(**fkw)),
            RunConfig(model=cfg, shape=SHAPES["train_4k"], fedsllm=FedsLLMConfig(**fkw)))


def to_torch(tree):
    return tree_map(lambda a: bridge.tensor_from_numpy(a, device="cpu"), jax.device_get(tree))


def pair(cfgs, jkw=None, tkw=None, **kw):
    """The reference's experiment and the port's (on the CPU) from the same
    config and keywords (``jkw``/``tkw``: each side's own objects), the
    port's state and variates set from the reference's."""
    kw.setdefault("allocator", "EB")
    jexp = JaxExperiment.from_config(cfgs[0], **kw, **(jkw or {}))
    texp = Experiment.from_config(cfgs[1], device="cpu", **kw, **(tkw or {}))
    texp.state = bridge.state_from_numpy(*jax.device_get(tuple(jexp.state)), device="cpu")
    if jexp.algo_state is not None:
        texp.algo_state = to_torch(jexp.algo_state)
    return jexp, texp


def rel_gap(got, want) -> float:
    """Largest |got - want| over the largest |want| (a tree of the port's
    against the reference's, leaf by leaf in the reference's order; or two
    numbers)."""
    if isinstance(want, (int, float)):
        return abs(got - want) / max(abs(want), 1e-30)
    gaps = []
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        gaps.append(float(np.max(np.abs(g - w))) / max(float(np.max(np.abs(w))), 1e-30))
    return max(gaps)


def lora_gap(tstate, jstate) -> float:
    """The adapters of the port's state against the reference's (the dicts'
    key orders may differ: compared key by key)."""
    gaps = []
    for side in ("lora_c", "lora_s"):
        got, want = getattr(tstate, side), jax.device_get(getattr(jstate, side))
        assert set(got) == set(want)
        gaps += [rel_gap(got[k][n], want[k][n]) for k in want for n in ("A", "B")]
    return max(gaps)


def assert_records_match(trecs, jrecs, tol=ROUND):
    """Campaign records: every host-side field bit for bit, the metrics
    within ``tol`` of their value."""
    assert len(trecs) == len(jrecs) > 0
    for t, j in zip(trecs, jrecs):
        for f in ("round", "client_ids", "mask", "alloc", "timing", "round_time",
                  "cumulative_time", "eta", "events", "staleness", "completion"):
            assert_same(getattr(t, f), getattr(j, f), f"round {j.round} {f}")
        assert set(t.metrics) == set(j.metrics)
        for k, v in j.metrics.items():
            assert rel_gap(t.metrics[k], v) <= tol, (j.round, k, t.metrics[k], v)


def bitwise(a, b):
    """Two trees of the port's tensors are equal bit for bit."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cfgs():
    return run_configs()


@pytest.fixture(scope="module")
def data(cfgs):
    return streams(cfgs[1].model.vocab_size)


@pytest.fixture(scope="module")
def campaign(cfgs, data):
    """A 3-round campaign of both packages: per-round channel re-sampling
    and joint re-allocation, a deadline and an elastic cohort of 3 of K=4.
    The deadline is the 0.7 quantile of round 0's simulated times (from
    ``events.round_state``, which prices a round without running it)."""
    jexp, texp = pair(cfgs, eta_search="warm")
    t0 = events.round_state(texp, texp.seed, 0, reallocate=True)[-1].total
    deadline = float(np.quantile(t0, 0.7))
    kw = dict(num_rounds=3, cohort=3, deadline=deadline, resample_channel=True,
              reallocate=True)
    jres = jexp.run(stream=data[0], **kw)
    tres = texp.run(stream=data[1], **kw)
    return jexp, texp, jres, tres


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def test_registries_hold_the_reference_names():
    """The nine axes, by the names the reference registers; unknown names
    raise KeyError listing the known ones."""
    for axis in AXES:
        reg, jreg = getattr(torch_api, axis), getattr(jax_api, axis)
        assert reg.names() == jreg.names(), axis
        with pytest.raises(KeyError, match="known") as exc:
            reg.get("definitely-not-registered")
        assert all(name in str(exc.value) for name in jreg.names())


@pytest.mark.parametrize("axis", ["aggregator", "allocator", "compressor", "scenario",
                                  "topology", "schedule", "local_algo", "workload",
                                  "population"])
def test_unknown_name_in_experiment_lists_known_names(cfgs, axis):
    reg = getattr(torch_api, {"topology": "topologies"}.get(axis, axis + "s"))
    with pytest.raises(KeyError, match=f"unknown {axis}") as exc:
        Experiment.from_config(cfgs[1], device="cpu", **{axis: "nope"})
    for name in reg.names():
        assert name in str(exc.value)


def test_from_config_defaults(cfgs):
    """The reference's defaults: weighted FedAvg, the ``proposed`` allocator
    (its solve handed in here), no codec, blockfade, star, sync, gd, iid,
    exact; the cut round(0.1 · groups) ≥ 1, the seed from ``train.seed``;
    the training η clamped; the model on the card unless asked otherwise."""
    jexp, _ = pair(cfgs)
    texp = Experiment.from_config(cfgs[1], device="cpu", net=jexp.net, alloc=jexp.alloc)
    names = (texp.aggregator_name, texp.allocator_name, texp.compressor_name,
             texp.scenario.name, texp.topology.name, texp.schedule.name, texp.local_algo.name,
             texp.workload.name, texp.population.name)
    assert names == ("weighted", "proposed", "none", "blockfade", "star", "sync", "gd",
                     "iid", "exact")
    assert texp.cut == 1 and texp.seed == cfgs[1].train.seed == 0
    assert texp.eta == min(float(jexp.alloc.eta), ETA_MAX)
    assert texp.state.round.device.type == "cpu" and texp.cohort == K
    assert texp.trace_count == 1 and texp.eta_buckets == [texp.eta]
    lora_cfg = Experiment.from_config(
        dataclasses.replace(cfgs[1], model=cfgs[1].model.replace(lora=None)), device="cpu",
        allocator="EB").cfg.lora
    assert lora_cfg == LoRAConfig(rank=8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            Experiment.from_config(cfgs[1], allocator="EB")


def test_construction_matches_reference(cfgs):
    """Network, attachment, allocation, η, timing and ``describe`` bit for
    bit, over scenarios, topologies and a codec that rescales s_bits."""
    for kw in ({}, {"scenario": "geo-blockfade", "topology": "edge-agg"},
               {"scenario": "drift", "topology": "edge-cloud", "compressor": "int8"},
               {"scenario": "hetero", "eta": 0.4, "seed": 3}):
        jexp, texp = pair(cfgs, **kw)
        assert texp.fcfg == dataclasses.replace(texp.fcfg, **dataclasses.asdict(jexp.fcfg))
        for f in ("net", "assign", "alloc", "eta", "timing", "cut"):
            assert_same(getattr(texp, f), getattr(jexp, f), f"{kw} {f}")
        assert texp.describe() == jexp.describe()
        assert texp.wall_clock_per_round == jexp.wall_clock_per_round
        np.testing.assert_array_equal(texp.client_weights(3).numpy(),
                                      np.asarray(jexp.client_weights(3)))


def test_construction_errors(cfgs):
    jexp, texp = pair(cfgs)
    with pytest.raises(ValueError, match="non-finite"):
        texp.set_eta(float("nan"))
    with pytest.raises(ValueError, match="no feasible allocation"):
        Experiment.from_config(cfgs[1], device="cpu", net=jexp.net,
                               alloc=dataclasses.replace(jexp.alloc, feasible=False))


def test_set_eta_and_reprice_timing_match_reference(cfgs):
    """set_eta quantizes onto the η-bucket grid and builds one round
    function per bucket; reprice_timing prices the current (net, alloc, η)."""
    jexp, texp = pair(cfgs)
    for eta in (0.93, 0.42, 0.44, 0.9, 0.05):
        assert texp.set_eta(eta) == jexp.set_eta(eta)
        assert_same(texp.reprice_timing(), jexp.reprice_timing())
    assert texp.eta_buckets == jexp.eta_buckets
    assert texp.trace_count == len(texp.eta_buckets)


# ---------------------------------------------------------------------------
# rounds and campaigns against the reference
# ---------------------------------------------------------------------------


def test_run_round_matches_reference(cfgs, data):
    """Two rounds (cohort ids, a mask, weight and update scales on the
    second): metrics and adapters within 1e-4, the same timing."""
    jexp, texp = pair(cfgs)
    jb, tb = data[0], data[1]
    jbatches = jax.tree.map(lambda *x: jnp.stack(x), *[jb.batch_at(k) for k in range(K)])
    tbatches = bridge.batches_from_numpy(jax.device_get(jbatches), device="cpu")
    kw2 = dict(client_ids=np.array([3, 0, 2, 1]), weight_scale=np.array([1.0, 0.5, 0.25, 1.0]),
               update_scale=0.75)
    for r, kw in enumerate(({}, kw2)):
        jres = jexp.run_round(jbatches, mask=None if r == 0 else jnp.array([1., 1., 0., 1.]), **kw)
        tres = texp.run_round(tbatches, mask=None if r == 0 else torch.tensor([1., 1., 0., 1.]),
                              **kw)
        assert isinstance(tres, RoundResult) and tres.state is texp.state
        assert_same(tres.timing, jres.timing) and tres.wall_clock == jres.wall_clock
        for k, v in jres.metrics.items():
            assert rel_gap(float(tres.metrics[k]), float(v)) <= ROUND, (r, k)
        assert lora_gap(texp.state, jexp.state) <= ROUND
        assert int(texp.state.round) == int(jexp.state.round) == r + 1
    assert texp.trace_count == 1


def test_campaign_matches_reference(campaign):
    """Three rounds with re-sampling, re-allocation, a deadline and an
    elastic cohort: the records' host-side fields bit for bit (networks
    priced, η adopted, cohorts, masks, events, simulated time), metrics and
    the final adapters within 1e-4; the campaign masks at least one client
    and never a whole cohort, so both paths of the mask run."""
    jexp, texp, jres, tres = campaign
    assert isinstance(tres, CampaignResult) and all(isinstance(r, RoundRecord)
                                                     for r in tres.records)
    assert_records_match(tres.records, jres.records)
    for f in ("total_time", "rounds_lemma1", "stopped_by", "scenario", "topology", "schedule",
              "population"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert tres.straggler_rate == jres.straggler_rate
    np.testing.assert_array_equal(tres.history("loss_round_start"),
                                  [r.metrics["loss_round_start"] for r in tres.records])
    masked = [r.stragglers for r in tres.records]
    assert max(masked) >= 1 and all(r.survivors >= 1 for r in tres.records), masked
    assert lora_gap(tres.state, jres.state) <= ROUND
    assert texp.campaign_time == jexp.campaign_time == tres.total_time


def test_trace_count_bounded_by_eta_buckets(campaign, cfgs, data):
    """One round function per η bucket: ≤ len(eta_buckets) under joint
    re-allocation, and 1 for a fixed-η campaign."""
    jexp, texp, _, _ = campaign
    assert texp.trace_count <= len(texp.eta_buckets)
    assert texp.eta_buckets == jexp.eta_buckets
    fixed = Experiment.from_config(cfgs[1], device="cpu", allocator="EB")
    fixed.run(num_rounds=2, stream=data[1], cohort=2)
    assert fixed.trace_count == 1 == len(fixed.eta_buckets)


@pytest.mark.parametrize("algo,kw", [("scaffold", {"schedule": "semi-async",
                                                   "population": "compact"}),
                                     ("fedprox", {"workload": "length-skew",
                                                  "compressor": "int8"})])
def test_campaign_axes_match_reference(cfgs, data, algo, kw):
    """Two rounds on other axes: scaffold's variates carried by the campaign
    (gathered and scattered through the compact window of a semi-async
    timeline), fedprox on length-skewed clients through the int8 uplink."""
    jkw = tkw = None
    if kw.get("schedule") == "semi-async":  # a buffer of 2 of the K = 4 clients
        from repro.des.schedules import SemiAsyncSchedule as JaxSemiAsync
        from repro_torch.des.schedules import SemiAsyncSchedule

        kw = {k: v for k, v in kw.items() if k != "schedule"}
        jkw, tkw = {"schedule": JaxSemiAsync(buffer_k=2)}, {"schedule": SemiAsyncSchedule(buffer_k=2)}
    jexp, texp = pair(cfgs, jkw=jkw, tkw=tkw, local_algo=algo, **kw)
    camp = dict(num_rounds=2, cohort=2, resample_channel=True)
    jres, tres = jexp.run(stream=data[0], **camp), texp.run(stream=data[1], **camp)
    assert_records_match(tres.records, jres.records)
    assert lora_gap(tres.state, jres.state) <= ROUND
    if algo == "scaffold":
        assert rel_gap(texp.algo_state, jexp.algo_state) <= ROUND


# ---------------------------------------------------------------------------
# within the port: bitwise invariants
# ---------------------------------------------------------------------------


def _fresh(cfgs, **kw):
    kw.setdefault("allocator", "EB")
    return Experiment.from_config(cfgs[1], device="cpu", **kw)


def test_single_round_campaign_equals_run_round(cfgs, data):
    """run(num_rounds=1, resample_channel=False, batches=b) ≡ run_round(b)."""
    tb = data[1]
    batches = tree_map(lambda *x: torch.stack(x), *[tb.batch_at(k) for k in range(K)])
    ref = _fresh(cfgs).run_round(batches)
    exp = _fresh(cfgs)
    res = exp.run(num_rounds=1, resample_channel=False, batches=batches)
    assert res.num_rounds == 1 and res.records[0].mask is None
    bitwise((ref.state.lora_c, ref.state.lora_s), (res.state.lora_c, res.state.lora_s))
    assert {k: float(v) for k, v in ref.metrics.items()} == res.records[0].metrics
    np.testing.assert_array_equal(res.records[0].timing.total, exp.timing.total)


def test_checkpoint_resume_is_bitwise(cfgs, data, tmp_path):
    """Interrupted after 2 of 4 rounds and resumed by a fresh experiment:
    the final state, the resumed records and the simulated clock equal the
    uninterrupted campaign's; a checkpoint that covers the ask runs nothing;
    another campaign's checkpoint, or a standard one, is refused."""
    kw = dict(stream=data[1], cohort=3, resample_channel=True, reallocate=True)
    full = _fresh(cfgs).run(num_rounds=4, **kw)
    ckpt = str(tmp_path / "camp")
    part = _fresh(cfgs).run(num_rounds=2, checkpoint_dir=ckpt, checkpoint_every=2, **kw)
    assert part.num_rounds == 2 and Checkpointer(ckpt).latest_step() == 2
    rest = _fresh(cfgs).run(num_rounds=4, checkpoint_dir=ckpt, resume=True, **kw)
    assert [r.round for r in rest.records] == [2, 3]
    assert rest.total_time == full.total_time
    bitwise(full.state, rest.state)
    for a, b in zip(full.records[2:], rest.records):
        assert a.metrics == b.metrics and a.round_time == b.round_time
    noop = _fresh(cfgs).run(num_rounds=2, checkpoint_dir=ckpt, resume=True, **kw)
    assert noop.num_rounds == 0 and noop.stopped_by == "checkpoint"
    for other, camp in (({}, {"campaign_seed": 123}), ({"local_algo": "fedprox"}, {}),
                        ({"scenario": "hetero"}, {}), ({"population": "compact"}, {})):
        with pytest.raises(ValueError, match="different campaign"):
            _fresh(cfgs, **other).run(num_rounds=6, checkpoint_dir=ckpt, resume=True,
                                      **kw, **camp)
    std = str(tmp_path / "std")
    Checkpointer(std).save(5, {"params": torch.ones(3)})
    with pytest.raises(ValueError, match="not a campaign checkpoint"):
        _fresh(cfgs).run(num_rounds=2, stream=data[1], checkpoint_dir=std, resume=True)


def test_scaffold_checkpoint_carries_variates(cfgs, data, tmp_path):
    kw = dict(stream=data[1], cohort=2, resample_channel=True)
    full_exp = _fresh(cfgs, local_algo="scaffold")
    full = full_exp.run(num_rounds=2, **kw)
    ckpt = str(tmp_path / "scaf")
    _fresh(cfgs, local_algo="scaffold").run(num_rounds=1, checkpoint_dir=ckpt,
                                            checkpoint_every=1, **kw)
    exp = _fresh(cfgs, local_algo="scaffold")
    rest = exp.run(num_rounds=2, checkpoint_dir=ckpt, resume=True, **kw)
    bitwise(full.state, rest.state)
    bitwise(full_exp.algo_state, exp.algo_state)


def test_in_session_continuation_matches_single_run(cfgs, data):
    kw = dict(stream=data[1], cohort=3, resample_channel=True)
    one = _fresh(cfgs).run(num_rounds=3, **kw)
    exp = _fresh(cfgs)
    exp.run(num_rounds=1, **kw)
    second = exp.run(num_rounds=3, **kw)
    assert [r.round for r in second.records] == [1, 2]
    bitwise(one.state, second.state)
    assert second.total_time == one.total_time
    assert exp.run(num_rounds=3, **kw).num_rounds == 0


def test_dp_campaign_noise_fresh_each_round_and_reproducible(cfgs, data):
    """DP with key=None: the same state at two round counters draws other
    noise; the same round counter the same noise; an explicit generator is
    reproducible; every upload is clipped (the clipped h_c norm per client
    ≤ the clip)."""
    exp = _fresh(cfgs, dp_clip=1.0, dp_noise=0.5)
    tb = data[1]
    batches = tree_map(lambda *x: torch.stack(x), *[tb.batch_at(k) for k in range(K)])
    s0 = exp.state
    a, _ = exp.round_fn(s0, batches)
    b, _ = exp.round_fn(s0._replace(round=torch.ones((), dtype=torch.int32)), batches)
    again, _ = exp.round_fn(s0, batches)
    assert max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a.lora_c),
                                                          tree_leaves(b.lora_c))) > 0
    bitwise(a.lora_c, again.lora_c)
    g1, _ = exp.round_fn(s0, batches, None, torch.Generator().manual_seed(7))
    g2, _ = exp.round_fn(s0, batches, None, torch.Generator().manual_seed(7))
    bitwise(g1.lora_c, g2.lora_c)


def test_campaign_argument_validation(cfgs, data):
    exp = _fresh(cfgs)
    tb = data[1]
    batches = tree_map(lambda *x: torch.stack(x), *[tb.batch_at(k) for k in range(K)])
    with pytest.raises(ValueError, match="exactly one"):
        exp.run(num_rounds=1)
    with pytest.raises(ValueError, match="exactly one"):
        exp.run(num_rounds=1, stream=tb, batches=batches)
    with pytest.raises(ValueError, match="cohort"):
        exp.run(num_rounds=1, stream=tb, cohort=K + 1)
    with pytest.raises(ValueError, match="num_rounds"):
        exp.run(stream=tb)
    with pytest.raises(ValueError, match="leading axis"):
        exp.run(num_rounds=1, batches=batches, cohort=2)
    with pytest.raises(ValueError, match="resample_channel"):
        exp.run(num_rounds=1, stream=tb, resample_channel=False, reallocate=True)
    with pytest.raises(ValueError, match="pass stream="):
        _fresh(cfgs, workload="dirichlet").run(num_rounds=1, batches=batches)


def test_lemma1_stopping(data):
    """Lemma 1's budget ⌈a/(1−η)⌉ caps the campaign (ε0 close to 1: a small a)."""
    exp = Experiment.from_config(run_configs(epsilon0=0.9)[1], device="cpu", allocator="EB")
    budget = fedsllm.global_round_count(exp.fcfg, exp.eta)
    assert budget <= 30  # else this test would be slow
    res = exp.run(num_rounds=50, stream=data[1], cohort=1, stop_at_lemma1=True,
                  resample_channel=False)
    assert res.num_rounds == budget == res.rounds_lemma1 and res.stopped_by == "lemma1"


# ---------------------------------------------------------------------------
# the checkpointer
# ---------------------------------------------------------------------------


def _tree():
    g = torch.Generator().manual_seed(0)
    return fedsllm.FedsLLMState(
        {"w": torch.randn(3, 4, generator=g).to(torch.bfloat16), "v": [torch.arange(5)]},
        {"a": {"A": torch.randn(2, 2, generator=g)}}, {}, torch.tensor(7, dtype=torch.int32))


def test_checkpointer_roundtrip_and_metadata(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(10, tree, {"note": "x", "t": np.float64(1.5), "r": np.int64(3),
                       "ids": np.arange(3)})
    got, meta = ck.restore()
    assert isinstance(got, fedsllm.FedsLLMState)
    bitwise(got, tree)
    assert (meta["step"], meta["note"], meta["t"], meta["r"], meta["ids"]) == \
        (10, "x", 1.5, 3, [0, 1, 2])
    assert json.load(open(os.path.join(ck._step_dir(10), "meta.json")))["n_leaves"] == 4
    with pytest.raises(TypeError, match="not JSON-serialisable"):
        ck.save(11, tree, {"bad": object()})
    assert ck.steps() == [10]  # the failed save left nothing behind


def test_checkpointer_retention_corruption_and_partial_writes(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, {"x": torch.full((2,), float(s))})
    assert ck.steps() == [2, 3]
    with open(os.path.join(ck._step_dir(3), "leaves.pt"), "wb") as f:
        f.write(b"garbage")
    tree, meta = ck.restore()
    assert meta["step"] == 2 and torch.equal(tree["x"], torch.full((2,), 2.0))
    assert os.path.exists(ck._step_dir(3) + ".corrupt")
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009"))  # no COMMITTED marker
    assert ck.latest_step() == 2
    assert Checkpointer(str(tmp_path / "empty")).restore_or_none() is None


def test_checkpointer_restores_onto_the_named_device(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.ones(2)})
    tree, _ = ck.restore(device="meta")
    assert tree["x"].device.type == "meta"


def test_compressor_rescales_the_delay_model(cfgs):
    full = _fresh(cfgs)
    comp = _fresh(cfgs, compressor="int8")
    assert comp.fcfg.s_bits == 0.25 * full.fcfg.s_bits
    assert comp.alloc.T <= full.alloc.T * (1 + 1e-9)
    assert comp.compressor == get_compressor("int8")
    assert comp._round_fn_kw["compressor"] == get_compressor("int8")
    assert full._round_fn_kw["compressor"] is None
