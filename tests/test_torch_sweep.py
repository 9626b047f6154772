"""The port's sweep (``sim/sweep.py``) against the reference, and its CLI.

A sweep builds one experiment per cell inside ``run_sweep``, so the port's
weights are set from the reference's at construction: ``fedsllm.init_state``
of the port is replaced, for the test, by the reference's initial state of
the same config, cut and seed, bridged. Both packages read the same numpy
batches. Every record field but the metrics, the summaries' times and
straggler rates, the cells' metadata and ``delay_reduction`` must be
bit-identical; metrics and the summaries' final losses within 1e-4 (the
round tolerance). The training η is pinned at 0.9 (I_loc = 2), as in the
round tests: ``BA`` prices at η = 0.1, and 33 local steps on this input
part even the reference from itself (its jitted and its eager round give
``loss_local_final`` 6.8e-4 apart).
"""

import json

import jax
import pytest

from repro.core import fedsllm as JF
from repro.sim.sweep import run_sweep as jax_run_sweep
from repro_torch import bridge
from repro_torch.api import Experiment, SweepResult
from repro_torch.core import fedsllm
from repro_torch.sim import sweep
from test_torch_alloc import assert_same
from test_torch_experiment import ROUND, rel_gap, run_configs, streams

K = 4
METRICS = ("loss_round_start", "loss_local_final", "h_c_norm")


@pytest.fixture(scope="module")
def sweeps():
    """A 1-round 2 x 2 sweep (blockfade, geo-blockfade) x (EB, BA) of both
    packages, cohort 3 of K = 4."""
    cfgs = run_configs(K=K)
    data = streams(cfgs[1].model.vocab_size)

    def reference_init(cfg, cut, seed=0, device="cuda"):
        jstate, _ = JF.init_state(cfgs[0].model, cut, key=jax.random.PRNGKey(seed))
        return bridge.state_from_numpy(*jax.device_get(tuple(jstate)), device=device)

    kw = dict(scenarios=("blockfade", "geo-blockfade"), allocators=("EB", "BA"), cohort=3,
              resample_channel=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fedsllm, "init_state", reference_init)
        got = sweep.run_sweep(cfgs[1], 1, stream=data[1],
                              exp_overrides={"eta": 0.9, "device": "cpu"}, **kw)
    return got, jax_run_sweep(cfgs[0], 1, stream=data[0], exp_overrides={"eta": 0.9}, **kw)


def test_sweep_records_match_reference(sweeps):
    got, want = sweeps
    assert isinstance(got, SweepResult) and len(got.records) == len(want.records) == 4
    for g, w in zip(got.records, want.records):
        assert set(g) == set(w)
        assert_same({k: v for k, v in g.items() if k not in METRICS},
                    {k: v for k, v in w.items() if k not in METRICS})
        for k in METRICS:
            assert rel_gap(g[k], w[k]) <= ROUND, (k, g[k], w[k])
    for f in ("scenarios", "allocators", "num_rounds", "topologies", "schedules", "local_algos",
              "workloads", "populations", "meta"):
        assert getattr(got, f) == getattr(want, f), f


def test_sweep_summaries_match_reference(sweeps, tmp_path):
    got, want = sweeps
    for g, w in zip(got.summary(), want.summary()):
        assert rel_gap(g.pop("final_loss"), w.pop("final_loss")) <= ROUND
        assert g == w
    assert got.delay_reduction(allocator="EB") == want.delay_reduction(allocator="EB")
    assert set(got.delay_reduction(allocator="EB")) == {"blockfade", "geo-blockfade"}
    assert got.schedule_speedup() == want.schedule_speedup() == {}
    assert got.local_algo_gain() == want.local_algo_gain() == {}
    assert got.cell("blockfade", "BA")[0]["allocator"] == "BA"
    path = got.to_json(str(tmp_path / "out" / "SWEEP_torch.json"))
    payload = json.load(open(path))
    assert payload["delay_reduction"] == {"allocator": "EB", "baseline": "BA",
                                          "pct_by_scenario": got.delay_reduction("EB", "BA")}
    assert len(payload["records"]) == 4 and payload["num_rounds"] == 1


def test_sweep_cli_writes_its_own_file(tmp_path, capsys):
    """``python -m repro_torch.sim.sweep`` on the CPU: the summary lines, the
    delay reduction, and ``results/SWEEP_torch.json`` as its default out."""
    out = tmp_path / "sweep.json"
    sweep.main(["--smoke", "--device", "cpu", "--scenarios", "blockfade", "--allocators", "EB",
                "BA", "--rounds", "1", "--clients", "3", "--cohort", "2", "--eta", "0.9",
                "--out", str(out)])
    text = capsys.readouterr().out
    assert "EB vs BA delay reduction" in text and f"wrote {out}" in text
    assert len(json.load(open(out))["records"]) == 2
    default = [a for a in sweep.main.__code__.co_consts if isinstance(a, str)
               and a.endswith(".json")]
    assert default == ["SWEEP_torch.json"]


def test_experiment_sweep_is_run_sweep():
    """``Experiment.sweep`` is ``run_sweep`` (bit for bit within the port);
    non-iid workloads need a stream."""
    cfg = run_configs(K=3)[1]
    stream = streams(cfg.model.vocab_size)[1]
    kw = dict(scenarios=("blockfade",), allocators=("EB",), stream=stream, cohort=2,
              exp_overrides={"device": "cpu"})
    a, b = Experiment.sweep(cfg, num_rounds=1, **kw), sweep.run_sweep(cfg, 1, **kw)
    assert a.records == b.records and a.meta == b.meta
    with pytest.raises(ValueError, match="require stream"):
        sweep.run_sweep(cfg, 1, workloads=("dirichlet",), batches={})
