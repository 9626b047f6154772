"""The port's input specs, spec trees, optimizer state on the meta device and
dry-run (``repro_torch.launch.{specs,steps,dryrun}``, ``config.list_archs``,
``config.shape_applicable``, ``models.transformer.cache_axes``) against the
reference's, on the CPU. The reference's trees are built live with
``jax.eval_shape``; its int32 tokens, labels and position are the port's int64."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as RC
from repro.launch import dryrun as RD
from repro.launch import mesh as RM
from repro.launch import specs as RSP
from repro.launch import steps as RST
from repro.models import transformer as RT
from repro.optim.optimizers import get_optimizer as ref_get_optimizer
from repro.parallel import RULESETS as REF_RULES
from repro_torch import config as PC
from repro_torch.kernels.attn_ops import flash_attention
from repro_torch.kernels.lora_ops import lora_matmul
from repro_torch.kernels.ssd_ops import ssd_scan
from repro_torch.launch import dryrun as PD
from repro_torch.launch import mesh as PM
from repro_torch.launch import specs as PSP
from repro_torch.launch import steps as PST
from repro_torch.models import transformer as PT
from repro_torch.models.registry import count_params
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.parallel import RULESETS

# the reference's token dtype and the port's
DTYPES = {"int32": torch.int64, "float32": torch.float32, "bfloat16": torch.bfloat16}
CELLS = [(a, s) for a in RC.list_archs() if a != "fedsllm-100m" for s in RC.SHAPES
         if RC.shape_applicable(a, s)]


def ref_paths(tree) -> dict:
    """{path: (shape, dtype name)} of a jax tree of arrays or ShapeDtypeStructs."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(p, "key", getattr(p, "idx", getattr(p, "name", None)))
                    for p in path)
        out[key] = leaf
    return out


def port_paths(tree, path=()) -> dict:
    """{path: leaf} of a port tree (dicts, tuples, lists)."""
    if isinstance(tree, (tuple, list)):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in port_paths(sub, path + (key,)).items()}
    return {path: tree}


def assert_same_specs(port_tree, ref_tree):
    port, ref = port_paths(port_tree), ref_paths(ref_tree)
    assert sorted(port, key=str) == sorted(ref, key=str)
    for k, r in ref.items():
        p = port[k]
        assert p.device.type == "meta", k
        assert tuple(p.shape) == tuple(r.shape), k
        assert p.dtype == DTYPES[jnp.dtype(r.dtype).name], (k, p.dtype, r.dtype)


def test_arch_list_and_applicability_equal_the_reference():
    assert PC.list_archs() == RC.list_archs()
    assert PC.LONG_CONTEXT_OK == RC.LONG_CONTEXT_OK
    for arch in RC.list_archs():
        for shape in RC.SHAPES:
            assert PC.shape_applicable(arch, shape) == RC.shape_applicable(arch, shape)
    assert list(PD.all_cells()) == list(RD.all_cells())


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    assert_same_specs(PSP.input_specs(arch, shape), RSP.input_specs(arch, shape))


def is_axes(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(e, (str, type(None))) for e in t)


def at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["gemma2-9b", "mamba2-130m", "recurrentgemma-9b",
                                  "whisper-base", "llava-next-mistral-7b"])
def test_spec_trees_match_reference(arch, shape):
    """cache_axes, batch_shardings and cache_shardings give the reference's
    axes and specs at every leaf, on the reference's pod mesh and on one card."""
    cfg, rcfg, sh = PC.get_arch(arch), RC.get_arch(arch), RC.SHAPES[shape]
    cache, rcache = PSP.cache_specs(cfg, PC.SHAPES[shape]), RSP.cache_specs(rcfg, sh)
    paths = port_paths(cache)
    ref_axes = ref_paths(jax.tree.map(lambda a: np.zeros(0), RT.cache_axes(rcache),
                                      is_leaf=is_axes))
    assert set(paths) == set(ref_axes)
    ref_axes_tree = RT.cache_axes(rcache)
    for path in paths:
        assert at(PT.cache_axes(cache), path) == at(ref_axes_tree, path), path
    kind = sh.kind
    for mesh_shape, mesh_axes in [((16, 16), ("data", "model")), ((1,), ("data",))]:
        rmesh = RM.make_abstract_mesh(mesh_shape, mesh_axes)
        pmesh = PM.make_abstract_mesh(mesh_shape, mesh_axes)
        ref_c = RST.cache_shardings(rcache, rmesh, REF_RULES[kind])
        port_c = PST.cache_shardings(cache, pmesh, RULESETS[kind])
        for path in paths:
            assert at(port_c, path) == tuple(at(ref_c, path).spec), path
        batch = PSP.train_batch_specs(cfg, PC.SHAPES[shape])
        rbatch = RSP.train_batch_specs(rcfg, sh)
        port_b = PST.batch_shardings(batch, pmesh, RULESETS[kind], kind)
        ref_b = RST.batch_shardings(rbatch, rmesh, REF_RULES[kind], kind)
        assert set(port_b) == set(ref_b)
        for k in ref_b:
            assert port_b[k] == tuple(ref_b[k].spec), (k, port_b[k], ref_b[k].spec)


def test_concrete_like_is_deterministic_and_in_range():
    cfg = PC.smoke_variant(PC.get_arch("llava-next-mistral-7b"))
    specs = PSP.cell_specs(cfg, PC.ShapeConfig("t", "decode", 32, 3))
    a = PSP.concrete_like(specs, seed=5, device="cpu")
    b = PSP.concrete_like(specs, seed=5, device="cpu")
    c = PSP.concrete_like(specs, seed=6, scale=2.0, device="cpu")
    for (k, s), x, y, z in zip(port_paths(specs).items(), port_paths(a).values(),
                               port_paths(b).values(), port_paths(c).values()):
        assert x.device.type == "cpu" and x.shape == s.shape and x.dtype == s.dtype, k
        assert torch.equal(x, y), k
        if x.dtype in (torch.int64, torch.int32):
            assert int(x.min()) >= 0 and int(x.max()) < 100, k
        else:
            assert torch.isfinite(x).all(), k
            if x.numel() > 64:
                assert not torch.equal(x, z), k
                assert 1.5 < float(z.float().std() / x.float().std()) < 2.6, k
    bools = PSP.concrete_like({"m": PSP.sds((4, 4), torch.bool)}, device="cpu")
    assert not bools["m"].any()


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_abstract_opt_state_matches_reference(name):
    arch = "olmoe-1b-7b"
    cfg, rcfg = PC.get_arch(arch), RC.get_arch(arch)
    tcfg, rtcfg = PC.TrainConfig(optimizer=name), RC.TrainConfig(optimizer=name)
    state = PST.abstract_opt_state(get_optimizer(name, 1e-3, tcfg),
                                   PT.init_params(cfg, device="meta"))
    rparams, _ = RT.init_params(rcfg, abstract=True)
    rstate = jax.eval_shape(ref_get_optimizer(name, 1e-3, rtcfg).init, rparams)
    assert_same_specs(state, rstate)


@pytest.mark.parametrize("arch,shape", [("whisper-base", "decode_32k"),
                                        ("mamba2-130m", "long_500k"),
                                        ("olmoe-1b-7b", "decode_32k")])
def test_plan_resident_bytes(arch, shape):
    cfg = PC.get_arch(arch)
    plan = PD.plan_cell(cfg, PC.SHAPES[shape], batch=2)
    leaves = port_paths(PT.init_params(cfg, device="meta")).values()
    assert sum(t.numel() for t in leaves) == count_params(cfg)
    esize = torch.empty(0, dtype=getattr(torch, cfg.param_dtype)).element_size()
    # count_params x the dtype's size, plus the fp32 leaves' extra bytes
    # (mamba2's A_log, D and dt_bias; olmoe's routers)
    odd = sum(t.numel() * (t.element_size() - esize) for t in leaves)
    assert plan["resident_bytes"]["params"] == count_params(cfg) * esize + odd
    assert (odd == 0) == (arch == "whisper-base")
    cache = PT.init_cache(cfg, 2, PC.SHAPES[shape].seq_len, device="meta")
    assert plan["resident_bytes"]["cache"] == PD.nbytes(cache)
    assert plan["resident_bytes"]["opt_state"] == 0
    fixed, row = PD.fixed_and_per_row(plan, "decode")
    r = plan["resident_bytes"]
    assert fixed == r["params"] + r["lora"]
    assert row * 2 == r["cache"] + r["batch"] + plan["output_bytes"]
    assert plan["flops"] > 0 and plan["plain_at_peak_ms"] > 0
    assert plan["collectives"]["bytes"] == 0


def lora_products(M, K, N, r):
    return 2 * M * (K * N + K * r + r * N)


def test_plan_flops_of_a_dense_prefill_equal_the_analytic_count():
    cfg = PC.smoke_variant(PC.get_arch("fedsllm-100m"))
    B, S = 2, 24
    plan = PD.plan_cell(cfg, PC.ShapeConfig("p", "prefill", S, B))
    M, D, F, V, r = B * S, cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.lora.rank
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    layer = (lora_products(M, D, H * hd, r) + 2 * lora_products(M, D, Kv * hd, r)
             + lora_products(M, H * hd, D, r)  # wq, wk, wv, wo
             + 2 * lora_products(M, D, F, r) + lora_products(M, F, D, r)  # gate, up, down
             + 2 * (2 * B * H * S * S * hd))  # logits and values over the whole rectangle
    want = cfg.num_layers * layer + 2 * M * D * V  # the head
    assert plan["flops"] == want
    assert plan["model_flops"] == 2.0 * count_params(cfg) * S * B
    assert plan["model_flops_ratio"] == pytest.approx(plan["model_flops"] / want)
    assert plan["output_bytes"] == B * S * V * 4  # fp32 logits
    assert 0 < plan["s2_bytes"] < plan["bytes_unfused"] or S < PD.S2_THRESHOLD


def test_plan_counts_score_traffic_at_long_sequences():
    """Score-shaped traffic is counted once the scores pass the threshold,
    in a serve (aten.einsum) and a train plan (its bmm products) alike."""
    cfg = PC.smoke_variant(PC.get_arch("fedsllm-100m"))
    for kind in ("prefill", "train"):
        plan = PD.plan_cell(cfg, PC.ShapeConfig("p", kind, 512, 1))
        # the fp32 logits (1, Kv, r, 512, 512) alone: written once, read by _scores
        assert plan["s2_bytes"] >= 2 * cfg.num_layers * cfg.num_heads * 512 * 512 * 4, kind
        assert plan["s2_bytes"] < plan["bytes_unfused"], kind


def test_plan_of_a_train_step_holds_the_optimizer_state():
    cfg = PC.smoke_variant(PC.get_arch("olmoe-1b-7b"))
    plan = PD.plan_cell(cfg, PC.ShapeConfig("t", "train", 32, 2))
    r = plan["resident_bytes"]
    assert r["opt_state"] == 2 * 4 * count_params(cfg)  # AdamW's m and v in fp32
    assert r["lora"] == 0 and r["cache"] == 0
    assert plan["output_bytes"] >= r["params"] + r["opt_state"]  # new params and state
    # forward, backward and the remat's second forward: more than 6·N·tokens
    assert plan["flops"] > plan["model_flops"]


# the reference's four composed keys, two at a time as the port's ms and
# transient bytes: (its ms key, its transient key, how a run holds each)
REF_PAIRS = [("flops_per_device", "bytes_per_device",
              lambda run: (run["flops_per_device"], run["bytes_per_device"])),
             ("s2_bytes_per_device", "collective_bytes_per_device",
              lambda run: (run["s2_bytes_per_device"], run["collectives"]["bytes_per_device"]))]


def as_port_record(rec: dict, read) -> dict:
    return {name: dict(zip(("ms", "transient_bytes"), read(run))) for name, run in rec.items()}


def synthetic(v: float, tail: bool, rng) -> dict:
    def run(x):
        return {"flops_per_device": x, "bytes_per_device": 2 * x + rng.uniform(0, 5),
                "s2_bytes_per_device": max(x - 50.0, 0.0),
                "collectives": {"bytes_per_device": rng.uniform(0, 100)}}

    rec = {"m1": run(v), "m2": run(v + rng.uniform(-40, 60))}
    if tail:
        rec["m1t"] = run(v + rng.uniform(-30, 30))
    return rec


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "gemma2-9b", "whisper-base"])
def test_compose_costs_matches_reference(arch):
    rng = np.random.default_rng(3)
    cfg, rcfg = PC.get_arch(arch), RC.get_arch(arch)
    tail = bool(cfg.num_layers % cfg.group_size)
    assert tail == (arch == "recurrentgemma-9b")
    cases = [synthetic(float(v), tail, rng) for v in rng.uniform(0, 200, 12)]
    # the clamps: per_group < 0 (M2 below M1), stem < 0 (M1 below per_group)
    cases.append({"m1": {**cases[0]["m1"], "flops_per_device": 10.0},
                  "m2": {**cases[0]["m1"], "flops_per_device": 5.0}})
    cases.append({"m1": {**cases[0]["m1"], "flops_per_device": 10.0},
                  "m2": {**cases[0]["m1"], "flops_per_device": 40.0}})
    for rec in cases:
        ref = RD.compose_costs(rec, rcfg)
        for ms_key, tr_key, read in REF_PAIRS:
            ours = PD.compose_costs(as_port_record(rec, read), cfg)
            for suffix in ("", "_per_group", "_stem"):
                assert ours["ms" + suffix] == ref[ms_key + suffix]
                assert ours["transient_bytes" + suffix] == ref[tr_key + suffix]
    measured = {"m1": {"ms": 3.0, "transient_bytes": 10.0},
                "m2": {"ms": 5.0, "transient_bytes": 9.0}}
    out = PD.compose_costs(measured, cfg)
    assert out["ms"] == 1.0 + cfg.num_groups * 2.0
    assert out["transient_bytes"] == 10.0 and out["transient_bytes_per_group"] == 0.0


def test_cli_plans_a_cell_on_the_cpu_into_its_out_dir(tmp_path):
    before = sorted(os.listdir(PD.REFERENCE_DIR)) if os.path.isdir(PD.REFERENCE_DIR) else None
    out = tmp_path / "dry"
    assert PD.main(["--arch", "mamba2-130m", "--shape", "long_500k", "--device", "cpu",
                    "--out", str(out)]) == 0
    assert PD.main(["--arch", "gemma2-9b", "--shape", "long_500k", "--device", "cpu",
                    "--out", str(out)]) == 0
    rec = json.loads((out / "mamba2-130m__long_500k.json").read_text())
    assert rec["ok"] and not rec["skipped"] and rec["fits"] is None and rec["max_batch"] is None
    assert rec["plan"]["resident_bytes"]["params"] >= 2 * rec["params_total"]
    skip = json.loads((out / "gemma2-9b__long_500k.json").read_text())
    assert skip["skipped"] and "500k" in skip["reason"]
    # incremental: an existing record is kept unless --force
    (out / "mamba2-130m__long_500k.json").write_text(json.dumps({"kept": True}))
    assert PD.run_cell("mamba2-130m", "long_500k", device="cpu", out_dir=str(out)) == \
        {"kept": True}
    assert PD.main(["--arch", "mamba2-130m", "--shape", "long_500k", "--device", "cpu",
                    "--out", str(out), "--force"]) == 0
    assert json.loads((out / "mamba2-130m__long_500k.json").read_text())["ok"]
    assert PD.RESULTS_DIR.endswith(os.path.join("results", "dryrun_torch"))
    with pytest.raises(ValueError, match="reference"):
        PD.run_cell("mamba2-130m", "long_500k", device="cpu", out_dir=PD.REFERENCE_DIR)
    after = sorted(os.listdir(PD.REFERENCE_DIR)) if os.path.isdir(PD.REFERENCE_DIR) else None
    assert after == before


def test_cli_failing_cell_is_recorded_and_fails_the_run(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("planned failure")

    monkeypatch.setattr(PD, "plan_cell", boom)
    assert PD.main(["--arch", "mamba2-130m", "--shape", "train_4k", "--device", "cpu",
                    "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "mamba2-130m__train_4k.json").read_text())
    assert rec["ok"] is False and "planned failure" in rec["error"]


def test_measure_cell_raises_without_a_card():
    cfg, shape = PC.smoke_variant(PC.get_arch("fedsllm-100m")), PC.SHAPES["decode_32k"]
    with pytest.raises(RuntimeError, match="CUDA"):
        PD.measure_cell(cfg, shape, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PD.measure_cell(cfg, shape, device="cuda")
    with pytest.raises(ValueError, match="measure"):
        PD.run_cell("mamba2-130m", "long_500k", device="cpu", measure=True,
                    out_dir=os.path.join(PD.RESULTS_DIR, "never"))
    assert not os.path.exists(os.path.join(PD.RESULTS_DIR, "never"))


def test_calibration_depths_are_the_references():
    for arch in RC.list_archs():
        cfg = PC.get_arch(arch)
        gs, rem = cfg.group_size, cfg.num_layers % cfg.group_size
        depths = PD.calibration_depths(cfg)
        assert depths["m1"] == gs and depths["m2"] == 2 * gs
        assert depths.get("m1t") == (gs + rem if rem else None)


def test_meta_calls_of_the_wrappers_launch_nothing():
    counts = [(f.launches, dict(f.variant_launches)) for f in (lora_matmul, flash_attention,
                                                               ssd_scan)]
    m = dict(device="meta", dtype=torch.bfloat16)
    y = lora_matmul(torch.empty(3, 5, 64, **m), torch.empty(64, 96, **m),
                    torch.empty(64, 8, **m), torch.empty(8, 96, **m), scale=2.0)
    assert y.device.type == "meta" and y.shape == (3, 5, 96) and y.dtype == torch.bfloat16
    o = flash_attention(torch.empty(2, 4, 300, 64, **m), torch.empty(2, 2, 300, 64, **m),
                        torch.empty(2, 2, 300, 64, **m), causal=True, window=128, softcap=50.0)
    assert o.device.type == "meta" and o.shape == (2, 4, 300, 64)
    f = dict(device="meta", dtype=torch.float32)
    ys, st = ssd_scan(torch.empty(1, 20, 2, 16, **m), torch.empty(1, 20, 2, **f),
                      torch.empty(2, **f), torch.empty(1, 20, 8, **m),
                      torch.empty(1, 20, 8, **m))
    assert ys.device.type == "meta" and ys.shape == (1, 20, 2, 16) and st.shape == (1, 2, 16, 8)
    assert counts == [(f.launches, dict(f.variant_launches)) for f in (lora_matmul,
                                                                       flash_attention, ssd_scan)]


def test_specs_batch_changes_only_the_batch():
    cfg = PC.get_arch("llava-next-mistral-7b")
    sh = PD.with_batch(PC.SHAPES["train_4k"], 4)
    assert dataclasses.replace(PC.SHAPES["train_4k"], global_batch=4) == sh
    b = PSP.train_batch_specs(cfg, sh)
    Tv = min(cfg.vision_tokens, 4096 // 2)
    assert b["vision_embeds"].shape == (4, Tv, 1024) and b["tokens"].shape == (4, 4096 - Tv)
    assert b["labels"].shape == (4, 4096) and b["tokens"].dtype == torch.int64
