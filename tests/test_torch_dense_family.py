"""The port's dense family (phi4-mini-3.8b, starcoder2-7b, command-r-35b,
gemma2-9b) against the reference, on the CPU.

Each config runs as its smoke variant in fp32 (``smoke_variant``: d_model 64,
head dim 16, vocab 256; gemma2's window becomes 32). Parameters and adapters
of the reference's tree are drawn with numpy and handed to both libraries
(the port's through ``repro_torch.bridge``), biases and norm scales away
from 0 and 1, so every feature of the family is live: layernorm with and without bias (starcoder2, command-r), projection
biases and the GELU MLP (starcoder2), the parallel block and logit scale
(command-r), and gemma2's ``LG`` groups with sliding-window layers, GeGLU,
post norms, both softcaps and the embedding multiplier.

Tolerance: 1e-5 of the largest value compared (per leaf of a tree), the
same fp32 function summed in another order by the two libraries; 1e-4 for a
whole round (``test_torch_train.py``'s ``ROUND``).
"""

import dataclasses
import functools
import math

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
from repro.models import layers as JL
from repro.models import registry as jax_registry
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.config import FedsLLMConfig, LoRAConfig, get_arch, smoke_variant
from repro_torch.core import fedsllm, split
from repro_torch.core import lora as torch_lora
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models import transformer as T

ARCHS = ["phi4-mini-3.8b", "starcoder2-7b", "command-r-35b", "gemma2-9b"]
ONE_PASS = 1e-5
ROUND = 1e-4
B = 2
ETA = 0.9  # I_loc = 2 (Lemma 2 with the paper's δ = 0.1)
# gemma2 at 3 layers: an LG group and an L tail, so that the tail's adapters
# ride on the server and sub_1's on the client (the smoke variant has one group)
DEEP = {"gemma2-9b": 3}
# the reference's functions compiled once per config (eager JAX compiles
# every operation of a new shape on its own, which is slower here)
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


def _configs(arch, layers=None):
    jcfg = jax_smoke_variant(jax_get_arch(arch)).replace(lora=JaxLoRAConfig(rank=4, alpha=8.0))
    cfg = smoke_variant(get_arch(arch)).replace(lora=LoRAConfig(rank=4, alpha=8.0))
    if layers:
        jcfg, cfg = jcfg.replace(num_layers=layers), cfg.replace(num_layers=layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _draw(tree, rng):
    """numpy values for the reference's abstract tree: weights N(0, 0.05²),
    norm scales 1 + N(0, 0.05²), biases N(0, 0.05²) (the reference's init
    would make biases 0 and scales 1, which hides a bias or scale the port
    drops), LoRA A ~ N(0, 1)/4 and B ~ N(0, 0.05²) (B = 0 would hide the
    adapters)."""
    def one(path, leaf):
        name = getattr(path[-1], "key", "")
        v = rng.standard_normal(leaf.shape)
        v = v / 4 if name == "A" else 0.05 * v + (name == "scale")
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


@functools.lru_cache(maxsize=None)
def _setup(arch, layers=None, cut=1):
    """Parameters and adapters of the reference's tree, drawn with numpy
    (``_draw``), in both libraries; adapters cut after group ``cut``.
    Shared, read-only."""
    jcfg, cfg = _configs(arch, layers)
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


def _tokens(cfg, S, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


def _batch(cfg, S, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
            "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}


# ---------------------------------------------------------------------------
# forward, loss, split gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,S", [(a, 64) for a in ARCHS]
                         + [("gemma2-9b", 48)])  # gemma2: banded, and a dense window mask
def test_forward_and_loss_match_reference(arch, S):
    """Logits of the plain path (merged weights), of the serving path (the
    adapters unmerged, the kernels' plain versions on the CPU) and the
    training loss against the reference's forward and loss_fn."""
    s = _setup(arch)
    batch = _batch(s["cfg"], S)
    jmerged = J_MERGE(s["jparams"], s["jfull"], s["jcfg"])
    jlogits, _ = J_FORWARD(jmerged, {k: jnp.asarray(v) for k, v in batch.items()}, s["jcfg"])
    jloss, _ = J_LOSS(jmerged, {k: jnp.asarray(v) for k, v in batch.items()}, s["jcfg"])
    tb = bridge.batches_from_numpy(batch, device="cpu")
    merged = torch_lora.merge(s["params"], s["full"], s["cfg"])
    with torch.no_grad():
        plain = T.forward(merged, tb, s["cfg"], kernels=False)
        served = T.forward(s["params"], tb, s["cfg"], lora=s["full"])
        loss, _ = T.loss_fn(merged, tb, s["cfg"])
    _close(plain, jlogits, ONE_PASS, "plain logits")
    _close(served, jlogits, ONE_PASS, "served logits")
    _close(loss, jloss, ONE_PASS, "loss")


@pytest.mark.parametrize("arch", ARCHS + ["gemma2-9b-deep"])
def test_split_value_and_grad_matches_reference(arch):
    """Loss and every adapter-gradient leaf of one split pass at cut=1
    against the reference's; split == monolithic inside the port."""
    name = arch.removesuffix("-deep")
    s = _setup(name, DEEP[name] if arch.endswith("-deep") else None)
    batch = _batch(s["cfg"], 48)
    jloss, jdc, jds, jinfo = J_SPLIT(
        s["jparams"], s["jlc"], s["jls"], {k: jnp.asarray(v) for k, v in batch.items()},
        s["jcfg"], 1)
    tb = bridge.batches_from_numpy(batch, device="cpu")
    loss, dc, ds, info = split.split_value_and_grad(s["params"], s["lc"], s["ls"], tb,
                                                    s["cfg"], 1)
    _close(loss, jloss, ONE_PASS, "loss")
    _close_lora(dc, jdc, ONE_PASS, "dlora_c")
    _close_lora(ds, jds, ONE_PASS, "dlora_s")
    assert info == {k: int(v) for k, v in jinfo.items()}
    mloss, mdc, mds = split.monolithic_value_and_grad(s["params"], s["lc"], s["ls"], tb,
                                                      s["cfg"], 1)
    _close(mloss, loss, 1e-6, "monolithic loss")
    for got, want in ((mdc, dc), (mds, ds)):
        for k in want:
            for n in ("A", "B"):
                _close(got[k][n], want[k][n], ONE_PASS, f"monolithic {k} {n}")


@pytest.mark.parametrize("fn", ["split", "monolithic"])
def test_an_adapter_outside_the_graph_raises(fn, monkeypatch):
    """gemma2 smoke at cut=1 puts its one group on the client: the server's
    adapters have zero size and take zero gradients, but an adapter of
    non-zero size that the forward never reads (here a merge that drops
    one) raises instead of taking a zero gradient."""
    s = _setup("gemma2-9b")
    tb = bridge.batches_from_numpy(_batch(s["cfg"], 16), device="cpu")
    grads = {"split": lambda: split.split_value_and_grad(s["params"], s["lc"], s["ls"], tb,
                                                        s["cfg"], 1)[1:3],
             "monolithic": lambda: split.monolithic_value_and_grad(s["params"], s["lc"], s["ls"],
                                                                   tb, s["cfg"], 1)[1:]}[fn]
    dc, ds = grads()
    assert all(v.numel() == 0 for ab in ds.values() for v in ab.values())
    assert any(v.abs().sum() > 0 for ab in dc.values() for v in ab.values())
    real = torch_lora.merge

    def dropping(base, lora, cfg):
        drop = next((k for k, ab in lora.items() if ab["A"].numel()), None)
        return real(base, {k: ab for k, ab in lora.items() if k != drop}, cfg)

    monkeypatch.setattr(torch_lora, "merge", dropping)
    with pytest.raises(RuntimeError, match="not have been used in the graph"):
        grads()


@pytest.mark.parametrize("how,S,window,softcap", [
    ("banded", 64, 16, 0.0), ("banded", 96, 32, 50.0),
    ("chunked", 48, 0, 0.0), ("chunked", 48, 20, 30.0),
])
def test_plain_attentions_match_reference(how, S, window, softcap):
    """The reference's other plain attentions against its own: banded
    sliding-window attention (S a multiple of the window) and query-chunked
    attention (prompts of 16384 tokens or more; chunks of 16 here), on
    GQA inputs (4 query heads over 2 kv heads, head dim 16)."""
    rng = np.random.default_rng(S + window)
    q, k, v = (rng.standard_normal((B, S, h, 16)).astype(np.float32) for h in (4, 2, 2))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    if how == "banded":
        got = L._attend_banded(tq, tk, tv, window=window, softcap=softcap)
        ref = functools.partial(JL._attend_banded, window=window, softcap=softcap)
    else:
        got = L._attend_chunked_q(tq, tk, tv, causal=True, window=window, softcap=softcap,
                                  chunk=16)
        ref = functools.partial(JL._attend_chunked_q, causal=True, window=window,
                                softcap=softcap, chunk=16)
    _close(got, jax.jit(ref)(jq, jk, jv), ONE_PASS, how)
    full = jax.jit(functools.partial(JL._attend_full, causal=True, window=window,
                                     softcap=softcap))(jq, jk, jv)
    _close(got, full, ONE_PASS, f"{how} vs dense")


# ---------------------------------------------------------------------------
# serving: prefill, decode and the ring-buffer cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,S", [(a, 16) for a in ARCHS]
                         + [("gemma2-9b", 64)])  # gemma2 (window 32): shorter, a multiple
def test_prefill_and_decode_match_reference(arch, S):
    """Prefill plus 4 decode steps (teacher-forced tokens) through the
    serving path against the reference's prefill and decode_step on merged
    weights; the plain prefill (merged weights; gemma2's S=64 is banded) as
    well. The caches hold S + 40 positions, so gemma2's L layers keep a
    ring buffer of 32 slots, which S=64's decode wraps."""
    s = _setup(arch)
    jcfg, cfg = s["jcfg"], s["cfg"]
    toks = _tokens(cfg, S + 4)
    jmerged = J_MERGE(s["jparams"], s["jfull"], jcfg)
    jcache = JT.init_cache(jcfg, B, S + 40)
    jlogits, jcache = J_PREFILL(jmerged, {"tokens": jnp.asarray(toks[:, :S])}, jcfg, jcache)
    t = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        cache = T.init_cache(cfg, B, S + 40, device="cpu")
        if cfg.sliding_window:
            assert cache["groups"]["sub_0"]["attn"][0].shape[2] == cfg.sliding_window
        logits, cache = T.prefill(s["params"], {"tokens": t[:, :S]}, cfg, cache, lora=s["full"])
        _close(logits, jlogits, ONE_PASS, "prefill")
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


def test_ragged_ring_decode_matches_reference_forward():
    """gemma2 smoke (window 32), a prompt of 40 tokens: not a multiple of
    the window. The port's decode steps after the prefill agree with the
    reference's forward over the longer sequence; the reference's own
    prefill stores the last 32 keys in slots 0..31, where its decode reads
    slot p % 32 as position p, and misses (ROADMAP.md §3)."""
    s = _setup("gemma2-9b")
    jcfg, cfg = s["jcfg"], s["cfg"]
    S, steps = 40, 3
    toks = _tokens(cfg, S + steps, seed=5)
    jmerged = J_MERGE(s["jparams"], s["jfull"], jcfg)
    jfwd, _ = J_FORWARD(jmerged, {"tokens": jnp.asarray(toks)}, jcfg)
    jcache = JT.init_cache(jcfg, B, S + steps)
    _, jcache = J_PREFILL(jmerged, {"tokens": jnp.asarray(toks[:, :S])}, jcfg, jcache)
    jstep, _ = J_DECODE(jmerged, jnp.asarray(toks[:, S:S + 1]), jcache,
                        jnp.asarray(S, jnp.int32), jcfg)
    t = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        cache = T.init_cache(cfg, B, S + steps, device="cpu")
        T.prefill(s["params"], {"tokens": t[:, :S]}, cfg, cache, lora=s["full"])
        for pos in range(S, S + steps):
            step, cache = T.decode_step(s["params"], t[:, pos:pos + 1], cache, pos, cfg,
                                        lora=s["full"])
            _close(step[:, 0], jfwd[:, pos], ONE_PASS, f"decode at {pos} vs forward")
    gap = float(np.max(np.abs(_np(jstep[:, 0]) - _np(jfwd[:, S]))))
    assert gap > 1e-2, gap


# ---------------------------------------------------------------------------
# a FedsLLM round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma2-9b", "command-r-35b"])
def test_round_fn_matches_reference(arch):
    """One build_round_fn round (gd, K=2 clients of 2 x 64 tokens, I_loc = 2)
    from the same state: metrics and the new adapters within 1e-4 of the
    largest value per leaf, at the smoke depth: gemma2's one LG group (its
    banded windowed attention under autograd) all on the client, the server
    holding the head only; command-r's parallel block, a layer each side."""
    s = _setup(arch)
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
    assert int(new.round) == 1


# ---------------------------------------------------------------------------
# parameter counts, structure, the embedding multiplier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + ["fedsllm-100m", "mamba2-130m"])
@pytest.mark.parametrize("smoke", [False, True])
def test_count_params_matches_the_tree_and_reference(arch, smoke):
    """The count (the element count of init_params on the meta device:
    shapes only, so the full configs cost nothing) equals the reference's,
    but for the layernorm biases that the reference's count leaves out
    (starcoder2: two norms a layer and the final norm, a fault of the
    reference, ROADMAP.md §3); the adapter count equals the reference's."""
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    if smoke:
        jcfg, cfg = jax_smoke_variant(jcfg), smoke_variant(cfg)
    n = registry.count_params(cfg)
    assert cfg.param_count() == n
    ln_bias = cfg.norm_type == "layernorm" and cfg.use_bias
    missed = cfg.d_model * (2 * cfg.num_layers + 1) if ln_bias else 0
    assert n - jax_registry.count_params(jcfg) == missed
    assert registry.count_params(cfg, trainable_only=True) == jax_lora.lora_param_count(jcfg)


def test_param_tree_matches_reference():
    """gemma2 at 5 layers: the same leaves, shapes and adapter key strings
    as the reference's tree (groups of sub_0/sub_1, an unstacked tail_0)."""
    jcfg, cfg = _configs("gemma2-9b", 5)
    jparams, axes = JT.init_params(jcfg, abstract=True)
    params = T.init_params(cfg, device="cpu")
    shapes = lambda tree: {jax.tree_util.keystr(p): tuple(v.shape)  # noqa: E731
                           for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(params) == shapes(jparams)
    assert params["groups"]["sub_1"]["attn"]["wq"].shape[0] == 2
    jfull, _ = jax_lora.init_lora(jparams, axes, jcfg, abstract=True)
    assert set(torch_lora.init_lora(params, cfg, device="cpu")) == set(jfull)
    cache = T.init_cache(cfg, B, 100, device="cpu")
    jcache = JT.init_cache(jcfg, B, 100)
    assert shapes(cache) == shapes(jcache)


def test_embedding_multiplier_rounds_like_the_reference_in_bf16():
    """gemma2's sqrt(3584) = 59.866 is 59.75 in bf16; the reference rounds
    the multiplier to the working dtype before the product, bit for bit."""
    jcfg = jax_smoke_variant(jax_get_arch("gemma2-9b")).replace(dtype="bfloat16",
                                                                param_dtype="bfloat16")
    cfg = smoke_variant(get_arch("gemma2-9b")).replace(dtype="bfloat16", param_dtype="bfloat16")
    assert cfg.embedding_multiplier == math.sqrt(3584.0)
    rng = np.random.default_rng(11)
    table = (3.0 * rng.standard_normal((cfg.vocab_size, cfg.d_model))).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, 32), dtype=np.int32)
    want = JL.embed_tokens({"tokens": jnp.asarray(table, jnp.bfloat16)}, jnp.asarray(toks), jcfg)
    got = L.embed_tokens({"tokens": torch.from_numpy(table).bfloat16()},
                         torch.from_numpy(toks.astype(np.int64)), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_unported_dense_features_still_raise():
    cfg = smoke_variant(get_arch("gemma2-9b"))
    for bad in (cfg.replace(layer_pattern="GL"), cfg.replace(family="encdec", layer_pattern="LG"),
                cfg.replace(family="vlm", layer_pattern="LG"), cfg.replace(family="hybrid")):
        with pytest.raises(NotImplementedError):
            T.init_params(bad, device="cpu")
