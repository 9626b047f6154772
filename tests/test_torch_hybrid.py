"""The port's hybrid family (recurrentgemma-9b: ``RRL`` groups of two RG-LRU
blocks and a sliding-window attention layer, an ``RR`` tail at full depth)
against the reference, on the CPU.

The config runs as its smoke variant in fp32 (``smoke_variant``: 3 layers,
one ``RRL`` group, d_model 64, lru width 64, MQA 4/1 at head dim 16, window
32, vocab 256), and at 5 layers (a group and an ``RR`` tail) where the split
engine needs layers on both sides of the cut. Parameters and adapters of the
reference's tree are drawn with numpy and handed to both libraries (the
port's through ``repro_torch.bridge``); the RG-LRU's gate parameters are
drawn too (the reference's init makes them 0 and 1), so that every gate is
live.

Tolerance: 1e-5 of the largest value compared (per leaf of a tree), the
same fp32 function summed in another order by the two libraries (the
linear recurrence: a doubling scan against ``associative_scan``); 1e-4 for
a whole round (``test_torch_train.py``'s ``ROUND``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedsLLMConfig as JaxFedsLLMConfig
from repro.config import LoRAConfig as JaxLoRAConfig
from repro.config import get_arch as jax_get_arch
from repro.config import smoke_variant as jax_smoke_variant
from repro.core import fedsllm as JF
from repro.core import lora as jax_lora
from repro.core import split as jax_split
from repro.models import registry as jax_registry
from repro.models import rglru as JRG
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.config import FedsLLMConfig, LoRAConfig, get_arch, smoke_variant
from repro_torch.core import fedsllm, split
from repro_torch.core import lora as torch_lora
from repro_torch.models import registry
from repro_torch.models import rglru as RG
from repro_torch.models import transformer as T

ARCH = "recurrentgemma-9b"
ONE_PASS = 1e-5
ROUND = 1e-4
B = 2
ETA = 0.9  # I_loc = 2 (Lemma 2 with the paper's δ = 0.1)
J_FORWARD = jax.jit(JT.forward, static_argnums=2)
J_LOSS = jax.jit(JT.loss_fn, static_argnums=2)
J_MERGE = jax.jit(jax_lora.merge, static_argnums=2)
J_PREFILL = jax.jit(JT.prefill, static_argnums=2)
J_DECODE = jax.jit(JT.decode_step, static_argnums=4)
J_SPLIT = jax.jit(jax_split.split_value_and_grad, static_argnums=(4, 5))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want), initial=0.0))
    scale = float(np.max(np.abs(want), initial=0.0))
    assert err <= tol * max(scale, 1e-30), f"{what}: {err:.3e} > {tol} x {scale:.3e}"
    return err


def _close_lora(got, want, tol, what=""):
    want = jax.device_get(want)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        for n in ("A", "B"):
            _close(got[k][n], want[k][n], tol, f"{what} {k} {n}")


def _configs(layers=None):
    jcfg = jax_smoke_variant(jax_get_arch(ARCH)).replace(lora=JaxLoRAConfig(rank=4, alpha=8.0))
    cfg = smoke_variant(get_arch(ARCH)).replace(lora=LoRAConfig(rank=4, alpha=8.0))
    if layers:
        jcfg, cfg = jcfg.replace(num_layers=layers), cfg.replace(num_layers=layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _draw(tree, rng):
    """numpy values for the reference's abstract tree: weights N(0, 0.05²),
    norm scales 1 + N(0, 0.05²), the RG-LRU gates w_a, b_a, w_x, b_x,
    lambda_p N(0, 0.5²) (around 0 and 1: sigmoid and softplus away from
    their init), LoRA A ~ N(0, 1)/4 and B ~ N(0, 0.05²)."""
    def one(path, leaf):
        name = getattr(path[-1], "key", "")
        v = rng.standard_normal(leaf.shape)
        if name == "A":
            v = v / 4
        elif name in ("w_a", "b_a", "w_x", "b_x", "lambda_p"):
            v = 0.5 * v + (name in ("w_x", "lambda_p"))
        else:
            v = 0.05 * v + (name == "scale")
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


@functools.lru_cache(maxsize=None)
def _setup(layers=None, cut=1):
    """Parameters and adapters of the reference's tree, drawn with numpy
    (``_draw``), in both libraries; adapters cut after group ``cut``."""
    jcfg, cfg = _configs(layers)
    shapes, axes = JT.init_params(jcfg, abstract=True)
    full, _ = jax_lora.init_lora(shapes, axes, jcfg, abstract=True)
    rng = np.random.default_rng(2)
    params, full = _draw(shapes, rng), _draw(full, rng)
    lc, ls = jax_lora.split_client_server(full, cut)
    return dict(jcfg=jcfg, cfg=cfg, jparams=params, jfull=full, jlc=lc, jls=ls,
                params=bridge.params_from_numpy(params, device="cpu"),
                full=bridge.lora_from_numpy(full, device="cpu"),
                lc=bridge.lora_from_numpy(lc, device="cpu"),
                ls=bridge.lora_from_numpy(ls, device="cpu"))


def _batch(cfg, S, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
            "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 7, 64, 100])
@pytest.mark.parametrize("h0", [False, True])
def test_linear_scan_matches_reference(S, h0):
    """h_t = a_t·h_{t-1} + b_t: the doubling scan against the reference's
    associative scan, from h0 = 0 and from a given h0, at lengths that are
    and are not powers of two."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (B, S, 8)).astype(np.float32)
    b = rng.standard_normal((B, S, 8)).astype(np.float32)
    h = rng.standard_normal((B, 8)).astype(np.float32) if h0 else None
    want = JRG._linear_scan(jnp.asarray(a), jnp.asarray(b), None if h is None else jnp.asarray(h))
    got = RG._linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                          None if h is None else torch.from_numpy(h))
    _close(got, want, ONE_PASS, "scan")
    loop = np.zeros((B, 8), np.float32) if h is None else h.copy()
    for t in range(S):  # the recurrence itself
        loop = a[:, t] * loop + b[:, t]
    _close(got[:, -1], loop, ONE_PASS, "scan vs loop")


def test_rglru_block_matches_reference():
    """One recurrent block (projections, conv, gates, scan, GeGLU gate) on a
    prompt, then one decode step from its cache, against the reference."""
    s = _setup()
    jcfg, cfg = s["jcfg"], s["cfg"]
    jp = {k: np.asarray(v[0]) for k, v in s["jparams"]["groups"]["sub_0"]["rglru"].items()}
    tp = bridge.params_from_numpy(jp, device="cpu")
    rng = np.random.default_rng(5)
    u = rng.standard_normal((B, 20, cfg.d_model)).astype(np.float32)
    jcache = JRG.init_rglru_cache(jcfg, B, jnp.float32)
    jy, jcache = JRG.apply_rglru_block(jp, jnp.asarray(u[:, :19]), jcfg, cache=jcache)
    jstep, jcache = JRG.apply_rglru_block(jp, jnp.asarray(u[:, 19:]), jcfg, cache=jcache)
    cache = RG.init_rglru_cache(cfg, B, torch.float32, device="cpu")
    with torch.no_grad():
        y = RG.apply_rglru_block(tp, torch.from_numpy(u[:, :19]), cfg, cache)
        step = RG.apply_rglru_block(tp, torch.from_numpy(u[:, 19:]), cfg, cache)
    _close(y, jy, ONE_PASS, "prefill")
    _close(step, jstep, ONE_PASS, "decode")
    _close(cache[0], jcache[0], ONE_PASS, "conv state")
    _close(cache[1], jcache[1], ONE_PASS, "h")
    assert cache[1].dtype == torch.float32


# ---------------------------------------------------------------------------
# forward, loss, serving, split gradients, a round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers,S", [(None, 64), (None, 48), (5, 40)])
def test_forward_and_loss_match_reference(layers, S):
    """Logits of the plain path (merged weights), of the serving path (the
    adapters unmerged) and the training loss, against the reference's
    forward and loss_fn: S=64 runs the L layer's banded attention, S=48 its
    dense window mask; 5 layers add the RR tail."""
    s = _setup(layers)
    batch = _batch(s["cfg"], S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmerged = J_MERGE(s["jparams"], s["jfull"], s["jcfg"])
    jlogits, _ = J_FORWARD(jmerged, jb, s["jcfg"])
    jloss, _ = J_LOSS(jmerged, jb, s["jcfg"])
    tb = bridge.batches_from_numpy(batch, device="cpu")
    merged = torch_lora.merge(s["params"], s["full"], s["cfg"])
    with torch.no_grad():
        plain = T.forward(merged, tb, s["cfg"], kernels=False)
        served = T.forward(s["params"], tb, s["cfg"], lora=s["full"])
        loss, m = T.loss_fn(merged, tb, s["cfg"])
    _close(plain, jlogits, ONE_PASS, "plain logits")
    _close(served, jlogits, ONE_PASS, "served logits")
    _close(loss, jloss, ONE_PASS, "loss")
    assert float(m["moe_aux"]) == 0.0


@pytest.mark.parametrize("layers,S", [(None, 32), (5, 64)])
def test_prefill_and_decode_match_reference(layers, S):
    """Prefill plus 4 decode steps (teacher-forced tokens) through the
    serving path against the reference's prefill and decode_step on merged
    weights, the ``rec`` caches (conv state and fp32 h) equal after the
    prefill. The cache holds S + 40 positions, so the L layer keeps a ring
    of 32 slots that every decode step here wraps past the window."""
    s = _setup(layers)
    jcfg, cfg = s["jcfg"], s["cfg"]
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 4), dtype=np.int32)
    jmerged = J_MERGE(s["jparams"], s["jfull"], jcfg)
    jcache = JT.init_cache(jcfg, B, S + 40)
    jlogits, jcache = J_PREFILL(jmerged, {"tokens": jnp.asarray(toks[:, :S])}, jcfg, jcache)
    t = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        cache = T.init_cache(cfg, B, S + 40, device="cpu")
        assert cache["groups"]["sub_2"]["attn"][0].shape[2] == cfg.sliding_window
        logits, cache = T.prefill(s["params"], {"tokens": t[:, :S]}, cfg, cache, lora=s["full"])
        _close(logits, jlogits, ONE_PASS, "prefill")
        for key in ("sub_0", "sub_1"):
            for i, what in enumerate(("conv state", "h")):
                _close(cache["groups"][key]["rec"][i], jcache["groups"][key]["rec"][i],
                       ONE_PASS, f"{key} {what}")
        if layers:
            _close(cache["tail_1"]["rec"][1], jcache["tail_1"]["rec"][1], ONE_PASS, "tail h")
        merged = torch_lora.merge(s["params"], s["full"], cfg)
        plain, _ = T.prefill(merged, {"tokens": t[:, :S]}, cfg,
                             T.init_cache(cfg, B, S + 40, device="cpu"), kernels=False)
        _close(plain, jlogits, ONE_PASS, "plain prefill")
        for pos in range(S, S + 4):
            jstep, jcache = J_DECODE(jmerged, jnp.asarray(toks[:, pos - 1:pos]), jcache,
                                     jnp.asarray(pos - 1, jnp.int32), jcfg)
            step, cache = T.decode_step(s["params"], t[:, pos - 1:pos], cache, pos - 1, cfg,
                                        lora=s["full"])
            _close(step, jstep, ONE_PASS, f"decode at {pos - 1}")


def test_split_value_and_grad_matches_reference():
    """Loss and every adapter-gradient leaf of one split pass at cut=1 on 5
    layers (the RRL group on the client, the RR tail on the server) against
    the reference's; split == monolithic inside the port; no aux term."""
    s = _setup(5)
    cfg = s["cfg"]
    batch = _batch(cfg, 48)
    jloss, jdc, jds, _ = J_SPLIT(
        s["jparams"], s["jlc"], s["jls"], {k: jnp.asarray(v) for k, v in batch.items()},
        s["jcfg"], 1)
    tb = bridge.batches_from_numpy(batch, device="cpu")
    loss, dc, ds, _ = split.split_value_and_grad(s["params"], s["lc"], s["ls"], tb, cfg, 1)
    _close(loss, jloss, ONE_PASS, "loss")
    _close_lora(dc, jdc, ONE_PASS, "dlora_c")
    _close_lora(ds, jds, ONE_PASS, "dlora_s")
    assert any("rglru" in k for k in dc) and any(k.startswith("['tail_1']") for k in ds)
    mloss, mdc, mds = split.monolithic_value_and_grad(s["params"], s["lc"], s["ls"], tb, cfg, 1)
    _close(mloss, loss, 1e-6, "monolithic loss")
    for got, want in ((mdc, dc), (mds, ds)):
        for k in want:
            for n in ("A", "B"):
                _close(got[k][n], want[k][n], ONE_PASS, f"monolithic {k} {n}")
    with torch.no_grad():
        full_loss, _ = T.loss_fn(torch_lora.merge(s["params"], s["full"], cfg), tb, cfg)
    _close(full_loss, loss, 1e-6, "loss_fn vs split loss")


def test_round_fn_matches_reference():
    """One build_round_fn round at 5 layers (gd, K=2 clients of 2 x 64
    tokens, I_loc = 2; the L layer banded under autograd) from the same
    state: metrics and new adapters within 1e-4 of the largest value per
    leaf."""
    s = _setup(5)
    jcfg, cfg = s["jcfg"], s["cfg"]
    K, S = 2, 64
    rng = np.random.default_rng(7)
    batches = {"tokens": rng.integers(0, cfg.vocab_size, (K, B, S), dtype=np.int32),
               "labels": rng.integers(0, cfg.vocab_size, (K, B, S), dtype=np.int32)}
    jstate = JF.FedsLLMState(s["jparams"], s["jlc"], s["jls"], jnp.zeros((), jnp.int32))
    jfn = jax.jit(JF.build_round_fn(jcfg, JaxFedsLLMConfig(num_clients=K), 1, ETA))
    jnew, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batches.items()})
    fn = fedsllm.build_round_fn(cfg, FedsLLMConfig(num_clients=K), 1, ETA)
    state = bridge.state_from_numpy(s["jparams"], s["jlc"], s["jls"], device="cpu")
    new, m = fn(state, bridge.batches_from_numpy(batches, device="cpu"))
    assert set(m) == set(jm)
    for k in jm:
        _close(m[k], jm[k], ROUND, k)
    _close_lora(new.lora_c, jnew.lora_c, ROUND, "lora_c")
    _close_lora(new.lora_s, jnew.lora_s, ROUND, "lora_s")


# ---------------------------------------------------------------------------
# parameter counts and structure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_param_counts_match_reference(smoke):
    """count_params (init_params on the meta device), active_param_count
    (every parameter: no experts) and the adapter count (w_rec_in,
    w_gate_in, w_out among them) equal the reference's, at full size
    (8.5 B: 12 RRL groups and the RR tail) and smoke size."""
    jcfg, cfg = jax_get_arch(ARCH), get_arch(ARCH)
    if smoke:
        jcfg, cfg = jax_smoke_variant(jcfg), smoke_variant(cfg)
    n = registry.count_params(cfg)
    assert n == jax_registry.count_params(jcfg)
    assert registry.active_param_count(cfg) == n == jax_registry.active_param_count(jcfg)
    assert torch_lora.lora_param_count(cfg) == jax_lora.lora_param_count(jcfg)


def test_param_and_cache_trees_match_reference():
    """At 5 layers: the same leaves, shapes and adapter key strings as the
    reference's tree (an RRL group, an RR tail, the fp32 gates), and the
    same cache tree (the rec caches' h in fp32, the L layer's ring)."""
    jcfg, cfg = _configs(5)
    jparams, axes = JT.init_params(jcfg, abstract=True)
    params = T.init_params(cfg.replace(param_dtype="bfloat16"), device="cpu")
    shapes = lambda tree: {jax.tree_util.keystr(p): tuple(v.shape)  # noqa: E731
                           for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(params) == shapes(jparams)
    rg = params["tail_0"]["rglru"]
    assert rg["lambda_p"].dtype == torch.float32 and rg["w_out"].dtype == torch.bfloat16
    jfull, _ = jax_lora.init_lora(jparams, axes, jcfg, abstract=True)
    assert set(torch_lora.init_lora(params, cfg, device="cpu")) == set(jfull)
    cache = T.init_cache(cfg, B, 100, dtype=torch.bfloat16, device="cpu")
    assert shapes(cache) == shapes(JT.init_cache(jcfg, B, 100))
    assert cache["tail_0"]["rec"][1].dtype == torch.float32
    assert cache["tail_0"]["rec"][0].dtype == torch.bfloat16
