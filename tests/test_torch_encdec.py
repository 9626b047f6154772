"""The port's encoder-decoder family (whisper-base) against the reference, on
the CPU.

The config runs as its smoke variant in fp32 (``smoke_variant``: 2 decoder
and 2 encoder layers, ``encoder_seq`` 32, d_model 64, MHA 4/4 at head dim
16, GELU MLP with biases, LayerNorm with biases, learned positions, no
RoPE). Parameters and adapters of the reference's tree (16 adapters: the
decoder's self- and cross-attention and MLP, the encoder's attention and
MLP) are drawn with numpy and handed to both libraries (the port's through
``repro_torch.bridge``), norm scales away from 1 and every bias non-zero
(the cross-attention's biases too, which neither library adds), and the
stub frame embeddings drawn N(0, 1).

Where the reference is right the port is held to it within 1e-5 of the
largest value compared (per leaf of a tree): the same fp32 function summed
in another order by the two libraries. Where it is not, the tests assert
both sides:
  * F1: the reference's decode loop carries no encoder output, so its
    decode step of whisper skips the cross-attention and fails; the port's
    decode cross-attends to the cache that the prefill filled;
  * F3: the reference's split slices the encoder's adapters at the cut as
    if they were decoder groups; the port's client takes them whole;
  * F4: the reference takes the (zero) cross cache for any one-token input,
    so a one-token prompt's prefill misses its forward and never fills the
    cache; the port projects the encoder's output at any prompt length.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LoRAConfig as JaxLoRAConfig
from repro.config import get_arch as jax_get_arch
from repro.config import smoke_variant as jax_smoke_variant
from repro.core import lora as jax_lora
from repro.core import split as jax_split
from repro.models import registry as jax_registry
from repro.models import transformer as JT
from repro.serving import decode as jax_decode
from repro_torch import bridge
from repro_torch.config import LoRAConfig, get_arch, smoke_variant
from repro_torch.core import split
from repro_torch.core import lora as torch_lora
from repro_torch.kernels.attn_ops import flash_attention
from repro_torch.kernels.lora_ops import lora_matmul
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.parallel.pipeline import pipelined_split_grads
from repro_torch.serving.decode import decode_tokens

ARCH = "whisper-base"
ONE_PASS = 1e-5
B = 2
J_FORWARD = jax.jit(JT.forward, static_argnums=2)
J_LOSS = jax.jit(JT.loss_fn, static_argnums=2)
J_MERGE = jax.jit(jax_lora.merge, static_argnums=2)
J_ENCODER = jax.jit(JT._run_encoder, static_argnums=2)
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
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        for n in ("A", "B"):
            _close(got[k][n], want[k][n], tol, f"{what} {k} {n}")


def _configs(enc_layers=2):
    jcfg = jax_smoke_variant(jax_get_arch(ARCH)).replace(lora=JaxLoRAConfig(rank=4, alpha=8.0),
                                                         num_encoder_layers=enc_layers)
    cfg = smoke_variant(get_arch(ARCH)).replace(lora=LoRAConfig(rank=4, alpha=8.0),
                                                num_encoder_layers=enc_layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _draw(tree, rng):
    """numpy values for the reference's abstract tree: weights, biases and
    positions N(0, 0.05²), norm scales 1 + N(0, 0.05²), LoRA A ~ N(0, 1)/4
    and B ~ N(0, 0.05²) (B = 0 would hide the adapters)."""
    def one(path, leaf):
        name = getattr(path[-1], "key", "")
        v = rng.standard_normal(leaf.shape)
        v = v / 4 if name == "A" else 0.05 * v + (name == "scale")
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


@functools.lru_cache(maxsize=None)
def _setup(enc_layers=2):
    """Parameters and adapters of the reference's tree, drawn with numpy
    (``_draw``), in both libraries."""
    jcfg, cfg = _configs(enc_layers)
    shapes, axes = JT.init_params(jcfg, abstract=True)
    full, _ = jax_lora.init_lora(shapes, axes, jcfg, abstract=True)
    rng = np.random.default_rng(2)
    params, full = _draw(shapes, rng), _draw(full, rng)
    return dict(jcfg=jcfg, cfg=cfg, jparams=params, jfull=full,
                params=bridge.params_from_numpy(params, device="cpu"),
                full=bridge.lora_from_numpy(full, device="cpu"))


def _batch(cfg, S, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
            "mask": (rng.random((B, S)) < 0.8).astype(np.float32),
            "frame_embeds": rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
            .astype(np.float32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            bridge.batches_from_numpy(batch, device="cpu"))


# ---------------------------------------------------------------------------
# structure and counts
# ---------------------------------------------------------------------------


def test_param_tree_and_adapters_match_reference():
    """The same leaves and shapes as the reference's tree (``enc_groups``,
    ``enc_final_norm``, ``enc_pos``, ``dec_pos``, each decoder layer's
    ``norm_x`` and ``xattn``), and the same 16 adapter key strings."""
    jcfg, cfg = _configs()
    jparams, axes = JT.init_params(jcfg, abstract=True)
    params = T.init_params(cfg, device="cpu")
    shapes = lambda tree: {jax.tree_util.keystr(p): tuple(v.shape)  # noqa: E731
                           for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(params) == shapes(jparams)
    assert params["dec_pos"].shape == (32768, cfg.d_model)
    jfull, _ = jax_lora.init_lora(jparams, axes, jcfg, abstract=True)
    lora = torch_lora.init_lora(params, cfg, device="cpu")
    assert set(lora) == set(jfull) and len(lora) == 16
    cache = T.init_cache(cfg, B, 12, device="cpu")
    jcache = JT.init_cache(jcfg, B, 12)
    assert shapes(cache) == shapes(jcache)
    assert cache["groups"]["sub_0"]["cross"][0].shape == (cfg.num_layers, B, cfg.encoder_seq, 4, 16)


@pytest.mark.parametrize("smoke", [False, True])
def test_count_params_counts_the_tree(smoke):
    """count_params is the tree's element count: whisper-base 88,240,640,
    the reference's 88,224,256 plus the 32 layernorm biases of 512 that its
    analytic count leaves out (smoke: 2,283,264 against 2,282,496);
    active_param_count equals it, and the adapter count is the reference's."""
    jcfg, cfg = jax_get_arch(ARCH), get_arch(ARCH)
    if smoke:
        jcfg, cfg = jax_smoke_variant(jcfg), smoke_variant(cfg)
    jparams, _ = JT.init_params(jcfg, abstract=True)
    tree = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(jparams))
    norms = 3 * cfg.num_layers + 2 * cfg.num_encoder_layers + 2  # each with a bias
    assert registry.count_params(cfg) == tree == jax_registry.count_params(jcfg) + norms * cfg.d_model
    assert registry.count_params(cfg) == (2_283_264 if smoke else 88_240_640)
    assert jax_registry.count_params(jcfg) == (2_282_496 if smoke else 88_224_256)
    assert registry.active_param_count(cfg) == registry.count_params(cfg)
    assert torch_lora.lora_param_count(cfg) == jax_lora.lora_param_count(jcfg)


# ---------------------------------------------------------------------------
# encoder, forward, loss, serving
# ---------------------------------------------------------------------------


def test_run_encoder_matches_reference():
    """The encoder's output (frames + enc_pos, non-causal layers without
    RoPE, final norm) on merged weights, and through the serving path with
    the encoder's adapters unmerged, against the reference's _run_encoder."""
    s = _setup()
    jb, tb = _both(_batch(s["cfg"], 8))
    jmerged = J_MERGE(s["jparams"], s["jfull"], s["jcfg"])
    want = J_ENCODER(jmerged, jb, s["jcfg"])
    merged = torch_lora.merge(s["params"], s["full"], s["cfg"])
    with torch.no_grad():
        plain = T._run_encoder(merged, tb, s["cfg"], kernels=False)
        served = T._run_encoder(s["params"], tb, s["cfg"], lora=s["full"])
    _close(plain, want, ONE_PASS, "plain encoder")
    _close(served, want, ONE_PASS, "served encoder")


def test_forward_and_loss_match_reference():
    """Logits of the plain path (merged weights), of the serving path (the
    adapters unmerged) and the training loss against the reference's."""
    s = _setup()
    jb, tb = _both(_batch(s["cfg"], 12))
    jmerged = J_MERGE(s["jparams"], s["jfull"], s["jcfg"])
    jlogits, _ = J_FORWARD(jmerged, jb, s["jcfg"])
    jloss, jm = J_LOSS(jmerged, jb, s["jcfg"])
    merged = torch_lora.merge(s["params"], s["full"], s["cfg"])
    with torch.no_grad():
        plain = T.forward(merged, tb, s["cfg"], kernels=False)
        served = T.forward(s["params"], tb, s["cfg"], lora=s["full"])
        loss, m = T.loss_fn(merged, tb, s["cfg"])
    _close(plain, jlogits, ONE_PASS, "plain logits")
    _close(served, jlogits, ONE_PASS, "served logits")
    _close(loss, jloss, ONE_PASS, "loss")
    _close(m["ce_loss"], jm["ce_loss"], ONE_PASS, "ce")


def test_prefill_and_decode_match_reference():
    """Prefill (S=4) and 4 decode steps (teacher-forced tokens) through the
    serving path against the reference's prefill and its decode_step given
    the encoder's output (with it, the reference's step is right): the
    port's steps cross-attend to the cache that its prefill filled, which
    holds the reference's cross keys and values."""
    s = _setup()
    jcfg, cfg = s["jcfg"], s["cfg"]
    S = 4
    batch = _batch(cfg, S + 4)
    toks = batch["tokens"]
    pre = dict(batch, tokens=toks[:, :S])
    jb, tb = _both(pre)
    jmerged = J_MERGE(s["jparams"], s["jfull"], jcfg)
    jenc = J_ENCODER(jmerged, jb, jcfg)
    jlogits, jcache = J_PREFILL(jmerged, jb, jcfg, JT.init_cache(jcfg, B, S + 8))
    t = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        cache = T.init_cache(cfg, B, S + 8, device="cpu")
        logits, cache = T.prefill(s["params"], tb, cfg, cache, lora=s["full"])
        _close(logits, jlogits, ONE_PASS, "prefill")
        for n in (0, 1):
            _close(cache["groups"]["sub_0"]["cross"][n], jcache["groups"]["sub_0"]["cross"][n],
                   ONE_PASS, f"cross cache {n}")
        for pos in range(S, S + 4):
            jstep, jcache = J_DECODE(jmerged, jnp.asarray(toks[:, pos - 1:pos]), jcache,
                                     jnp.asarray(pos - 1, jnp.int32), jcfg, jenc)
            step, cache = T.decode_step(s["params"], t[:, pos - 1:pos], cache, pos - 1, cfg,
                                        lora=s["full"])
            _close(step, jstep, ONE_PASS, f"decode at {pos - 1}")
        # the launcher's serve step, given the encoder's output or not
        serve_step = steps.make_serve_step(cfg)
        merged = torch_lora.merge(s["params"], s["full"], cfg)
        for enc_out in (None, T._run_encoder(merged, tb, cfg, kernels=False)):
            nxt, _ = serve_step(merged, t[:, S + 3:S + 4], cache, S + 3, enc_out=enc_out)
            want, _ = J_DECODE(jmerged, jnp.asarray(toks[:, S + 3:S + 4]), jcache,
                               jnp.asarray(S + 3, jnp.int32), jcfg, jenc)
            assert nxt[:, 0].tolist() == np.asarray(want[:, -1].argmax(-1)).tolist()


def test_decode_tokens_runs_where_the_reference_loop_raises():
    """F1. The reference's make_prefill_fn builds a DecodeState without the
    encoder's output, so its decode step skips the cross-attention and the
    layer scan raises on the missing ``cross`` cache. The port's
    decode_tokens serves whisper: its tokens equal a greedy loop of the
    reference's own decode_step given the encoder's output."""
    s = _setup()
    jcfg, cfg = s["jcfg"], s["cfg"]
    S, new = 4, 5
    batch = _batch(cfg, S)
    jb, _ = _both(batch)
    jmerged = J_MERGE(s["jparams"], s["jfull"], jcfg)
    state = jax_decode.make_prefill_fn(jcfg)(jmerged, jb, JT.init_cache(jcfg, B, S + new))
    assert state.enc_out is None
    with pytest.raises(ValueError, match="cross"):
        jax_decode.make_decode_fn(jcfg)(jmerged, state)
    jenc = J_ENCODER(jmerged, jb, jcfg)
    want, tok, cache = [state.tokens], state.tokens, state.cache
    for pos in range(S, S + new - 1):
        logits, cache = J_DECODE(jmerged, tok, cache, jnp.asarray(pos, jnp.int32), jcfg, jenc)
        tok = jnp.argmax(logits[:, -1:], axis=-1)
        want.append(tok)
    got = decode_tokens(s["params"], cfg, torch.from_numpy(batch["tokens"].astype(np.int64)),
                        new, lora=s["full"], device="cpu",
                        inputs={"frame_embeds": torch.from_numpy(batch["frame_embeds"])})
    assert got.tolist() == np.concatenate(want, axis=1).tolist()


def test_one_token_prefill_fills_the_cross_cache():
    """F4. A one-token prompt: the reference's prefill takes the zero cross
    cache (it treats any one-token input as a decode step), misses its own
    forward and leaves the cache at zero; the port's equals the forward and
    fills the cache with the encoder's keys and values."""
    s = _setup()
    jcfg, cfg = s["jcfg"], s["cfg"]
    jb, tb = _both(_batch(cfg, 1))
    jmerged = J_MERGE(s["jparams"], s["jfull"], jcfg)
    jfwd, _ = J_FORWARD(jmerged, jb, jcfg)
    jpre, jcache = J_PREFILL(jmerged, jb, jcfg, JT.init_cache(jcfg, B, 4))
    gap = float(np.max(np.abs(np.asarray(jpre) - np.asarray(jfwd))))
    assert gap > 1e-3 * float(np.max(np.abs(np.asarray(jfwd)))), gap
    assert not np.any(np.asarray(jcache["groups"]["sub_0"]["cross"][0]))
    # the cross keys depend on the frames only: a longer prompt's prefill fills them
    _, jfilled = J_PREFILL(jmerged, dict(jb, tokens=jnp.tile(jb["tokens"], (1, 2))), jcfg,
                           JT.init_cache(jcfg, B, 4))
    with torch.no_grad():
        cache = T.init_cache(cfg, B, 4, device="cpu")
        pre, cache = T.prefill(s["params"], tb, cfg, cache, lora=s["full"])
    _close(pre, jfwd, ONE_PASS, "one-token prefill vs forward")
    for n in (0, 1):
        _close(cache["groups"]["sub_0"]["cross"][n], jfilled["groups"]["sub_0"]["cross"][n],
               ONE_PASS, f"cross cache {n}")


def test_encoder_and_cross_attention_route_through_flash_non_causal(monkeypatch):
    """With ``kernels=True`` a prefill calls the flash wrapper once an
    encoder layer (non-causal, Sq = Skv = encoder_seq), and per decoder
    layer once causal (self) and once non-causal (cross, Sq = S, Skv =
    encoder_seq); every adapted projection calls the LoRA wrapper. On the
    CPU the wrappers run their plain versions: no kernel launches."""
    s = _setup()
    cfg = s["cfg"]
    S = 6
    calls, real = [], L.flash_attention

    def record(q, k, v, **kw):
        calls.append((kw["causal"], q.shape[2], k.shape[2]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(L, "flash_attention", record)
    flash_attention.launches = lora_matmul.launches = 0
    _, tb = _both(_batch(cfg, S))
    with torch.no_grad():
        T.prefill(s["params"], tb, cfg, T.init_cache(cfg, B, S + 1, device="cpu"),
                  lora=s["full"])
    Se = cfg.encoder_seq
    assert calls == ([(False, Se, Se)] * cfg.num_encoder_layers
                     + [(True, S, S), (False, S, Se)] * cfg.num_layers)
    assert flash_attention.launches == lora_matmul.launches == 0


# ---------------------------------------------------------------------------
# split learning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("enc_layers", [2, 3])
def test_split_gives_the_client_the_whole_encoder(enc_layers):
    """F3. The port's split pass at cut 1 (the encoder's adapters all on the
    client) equals the reference's loss_fn on merge(params, join(lc, ls)),
    differentiated by jax.grad and re-cut the port's way; and split ==
    monolithic inside the port. The reference's own split slices the
    encoder's adapters at the cut: with 2 encoder layers its loss differs
    from its loss_fn's, and with 3 its split raises (a (2, ...) delta added
    to a (3, ...) weight)."""
    s = _setup(enc_layers)
    jcfg, cfg = s["jcfg"], s["cfg"]
    cut = 1
    jb, tb = _both(_batch(cfg, 12))
    lc, ls = torch_lora.split_client_server(s["full"], cut)
    assert all(k in lc and k not in ls for k in s["full"] if k.startswith("['enc_groups']"))
    assert torch_lora.join_client_server(lc, ls).keys() == s["full"].keys()

    def jloss(full):
        return JT.loss_fn(jax_lora.merge(s["jparams"], full, jcfg), jb, jcfg)[0]

    want, jgrad = jax.jit(jax.value_and_grad(jloss))(s["jfull"])
    gc, gs = torch_lora.split_client_server(
        bridge.lora_from_numpy(jax.device_get(jgrad), device="cpu"), cut)
    loss, dc, ds, info = split.split_value_and_grad(s["params"], lc, ls, tb, cfg, cut)
    _close(loss, want, ONE_PASS, "split loss")
    _close_lora(dc, gc, ONE_PASS, "dlora_c")
    _close_lora(ds, gs, ONE_PASS, "dlora_s")
    D = cfg.d_model
    assert info == {"smashed_bytes": 4 * B * (12 + cfg.encoder_seq) * D,
                    "smashed_bits_uplink": 32 * B * (12 + cfg.encoder_seq) * D,
                    "grad_bytes": 4 * B * 12 * D}
    mloss, mdc, mds = split.monolithic_value_and_grad(s["params"], lc, ls, tb, cfg, cut)
    _close(mloss, loss, 1e-6, "monolithic loss")
    _close_lora(mdc, dc, ONE_PASS, "monolithic dlora_c")
    _close_lora(mds, ds, ONE_PASS, "monolithic dlora_s")
    jlc, jls = jax_lora.split_client_server(s["jfull"], cut)
    if enc_layers == 3:
        with pytest.raises((TypeError, ValueError)):
            J_SPLIT(s["jparams"], jlc, jls, jb, jcfg, cut)
        return
    jsplit = float(J_SPLIT(s["jparams"], jlc, jls, jb, jcfg, cut)[0])
    assert abs(jsplit - float(want)) > 1e-4 * abs(float(want)), (jsplit, float(want))


def test_pipelined_split_slices_the_frames():
    """pipelined_split_grads (M = 2) slices ``frame_embeds`` with the rest of
    the batch: it equals the full-batch split step (no mask: the mean of
    the microbatches' masked means is the full batch's only with equal
    counts)."""
    s = _setup()
    cfg = s["cfg"]
    batch = _batch(cfg, 8)
    del batch["mask"]
    _, tb = _both(batch)
    lc, ls = torch_lora.split_client_server(s["full"], 1)
    loss, dc, ds, _ = split.split_value_and_grad(s["params"], lc, ls, tb, cfg, 1)
    mloss, mdc, mds = pipelined_split_grads(s["params"], lc, ls, tb, cfg, 1, 2)
    _close(mloss, loss, ONE_PASS, "pipelined loss")
    _close_lora(mdc, dc, ONE_PASS, "pipelined dlora_c")
    _close_lora(mds, ds, ONE_PASS, "pipelined dlora_s")
