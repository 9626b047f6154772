"""The port's vision-language family (llava-next-mistral-7b) against the
reference, on the CPU.

The config runs as its smoke variant in fp32 (``smoke_variant``: 2 layers,
d_model 64, GQA 4/2 at head dim 16, SwiGLU, RMSNorm, RoPE, 8 vision
tokens). The vision frontend is a stub in both libraries: precomputed
patch embeddings (B, Tv, 1024) go through the two-layer projector and in
front of the tokens, so a batch holds Tv + S positions and its labels and
mask are (B, Tv + S), as the reference's ``launch/specs.py`` lays a batch
out. Parameters and adapters of the reference's tree (7 adapters: the
projector is not a LoRA target) are drawn with numpy and handed to both
libraries (the port's through ``repro_torch.bridge``), the projector's
biases non-zero.

Where the reference is right the port is held to it within 1e-5 of the
largest value compared (per leaf of a tree); 1e-4 for a whole round
(``test_torch_train.py``'s ``ROUND``). Where it is not (F2: the
reference's decode loop starts a vision prompt at position S, not Tv + S),
the test asserts both sides.
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
from repro.models import transformer as JT
from repro.serving import decode as jax_decode
from repro_torch import bridge
from repro_torch.config import FedsLLMConfig, LoRAConfig, get_arch, smoke_variant
from repro_torch.core import fedsllm, split
from repro_torch.core import lora as torch_lora
from repro_torch.kernels.attn_ops import flash_attention
from repro_torch.kernels.lora_ops import lora_matmul
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.serving.decode import decode_tokens, make_decode_fn, make_prefill_fn

ARCH = "llava-next-mistral-7b"
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


def _configs():
    jcfg = jax_smoke_variant(jax_get_arch(ARCH)).replace(lora=JaxLoRAConfig(rank=4, alpha=8.0))
    cfg = smoke_variant(get_arch(ARCH)).replace(lora=LoRAConfig(rank=4, alpha=8.0))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _draw(tree, rng):
    """numpy values for the reference's abstract tree: weights and biases
    N(0, 0.05²), norm scales 1 + N(0, 0.05²), LoRA A ~ N(0, 1)/4 and B ~
    N(0, 0.05²) (B = 0 would hide the adapters)."""
    def one(path, leaf):
        name = getattr(path[-1], "key", "")
        v = rng.standard_normal(leaf.shape)
        v = v / 4 if name == "A" else 0.05 * v + (name == "scale")
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


@functools.lru_cache(maxsize=None)
def _setup(cut=1):
    """Parameters and adapters of the reference's tree, drawn with numpy
    (``_draw``), in both libraries; adapters cut after group ``cut``."""
    jcfg, cfg = _configs()
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


def _batch(cfg, S, seed=3, lead=(B,)):
    """A batch of S positions, as ``launch/specs.py`` lays one out: Tv =
    min(vision_tokens, S // 2) patches, S - Tv tokens, labels and mask of S."""
    rng = np.random.default_rng(seed)
    Tv = min(cfg.vision_tokens, S // 2)
    return {"tokens": rng.integers(0, cfg.vocab_size, lead + (S - Tv,), dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, lead + (S,), dtype=np.int32),
            "mask": (rng.random(lead + (S,)) < 0.8).astype(np.float32),
            "vision_embeds": rng.standard_normal(lead + (Tv, 1024)).astype(np.float32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            bridge.batches_from_numpy(batch, device="cpu"))


# ---------------------------------------------------------------------------
# structure and counts
# ---------------------------------------------------------------------------


def test_param_tree_and_adapters_match_reference():
    """The same leaves and shapes as the reference's tree (the projector
    {w1 (1024, D), b1, w2 (D, D), b2}) and the same 7 adapter key strings;
    the same cache tree."""
    jcfg, cfg = _configs()
    jparams, axes = JT.init_params(jcfg, abstract=True)
    params = T.init_params(cfg, device="cpu")
    shapes = lambda tree: {jax.tree_util.keystr(p): tuple(v.shape)  # noqa: E731
                           for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(params) == shapes(jparams)
    assert params["projector"]["w1"].shape == (1024, cfg.d_model)
    jfull, _ = jax_lora.init_lora(jparams, axes, jcfg, abstract=True)
    lora = torch_lora.init_lora(params, cfg, device="cpu")
    assert set(lora) == set(jfull) and len(lora) == 7
    assert shapes(T.init_cache(cfg, B, 12, device="cpu")) == shapes(JT.init_cache(jcfg, B, 12))


@pytest.mark.parametrize("smoke", [False, True])
def test_param_counts_match_reference(smoke):
    """count_params (the tree's element count), active_param_count and the
    adapter count equal the reference's: llava-next-mistral-7b
    7,262,711,808 (RMSNorm has no bias, so the reference's analytic count
    is the tree's)."""
    jcfg, cfg = jax_get_arch(ARCH), get_arch(ARCH)
    if smoke:
        jcfg, cfg = jax_smoke_variant(jcfg), smoke_variant(cfg)
    assert registry.count_params(cfg) == jax_registry.count_params(jcfg)
    assert registry.active_param_count(cfg) == registry.count_params(cfg)
    assert torch_lora.lora_param_count(cfg) == jax_lora.lora_param_count(jcfg)
    if not smoke:
        assert registry.count_params(cfg) == 7_262_711_808


# ---------------------------------------------------------------------------
# forward, loss, serving
# ---------------------------------------------------------------------------


def test_forward_and_loss_match_reference():
    """Logits over Tv + S positions of the plain path (merged weights), of
    the serving path (the adapters unmerged) and the training loss, against
    the reference's."""
    s = _setup()
    jb, tb = _both(_batch(s["cfg"], 16))
    jmerged = J_MERGE(s["jparams"], s["jfull"], s["jcfg"])
    jlogits, _ = J_FORWARD(jmerged, jb, s["jcfg"])
    jloss, jm = J_LOSS(jmerged, jb, s["jcfg"])
    merged = torch_lora.merge(s["params"], s["full"], s["cfg"])
    with torch.no_grad():
        plain = T.forward(merged, tb, s["cfg"], kernels=False)
        served = T.forward(s["params"], tb, s["cfg"], lora=s["full"])
        loss, m = T.loss_fn(merged, tb, s["cfg"])
    assert plain.shape[1] == 16
    _close(plain, jlogits, ONE_PASS, "plain logits")
    _close(served, jlogits, ONE_PASS, "served logits")
    _close(loss, jloss, ONE_PASS, "loss")
    _close(m["ce_loss"], jm["ce_loss"], ONE_PASS, "ce")


def test_prefill_and_decode_match_reference():
    """Prefill (Tv = 4 patches and S = 4 tokens) and 4 decode steps
    (teacher-forced tokens) at positions Tv + S on, through the serving
    path, against the reference's prefill and decode_step at the same
    positions."""
    s = _setup()
    jcfg, cfg = s["jcfg"], s["cfg"]
    batch = _batch(cfg, 8)
    Tv, S = 4, 4
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 4), dtype=np.int32)
    jb, tb = _both(batch)
    jmerged = J_MERGE(s["jparams"], s["jfull"], jcfg)
    jlogits, jcache = J_PREFILL(jmerged, jb, jcfg, JT.init_cache(jcfg, B, Tv + S + 4))
    with torch.no_grad():
        cache = T.init_cache(cfg, B, Tv + S + 4, device="cpu")
        logits, cache = T.prefill(s["params"], tb, cfg, cache, lora=s["full"])
        _close(logits, jlogits, ONE_PASS, "prefill")
        for i in range(4):
            pos = Tv + S + i
            jstep, jcache = J_DECODE(jmerged, jnp.asarray(toks[:, i:i + 1]), jcache,
                                     jnp.asarray(pos, jnp.int32), jcfg)
            step, cache = T.decode_step(s["params"], torch.from_numpy(toks[:, i:i + 1]).long(),
                                        cache, pos, cfg, lora=s["full"])
            _close(step, jstep, ONE_PASS, f"decode at {pos}")


def test_decode_after_a_vision_prefill_continues_at_tv_plus_s():
    """F2. The first decode step after a vision prefill equals the forward
    over the appended sequence in the port, whose prefill function starts
    decoding at the Tv + S positions written. The reference's starts at S:
    its step overwrites the cache's slot S, ropes at position S and misses
    its own forward."""
    s = _setup()
    jcfg, cfg = s["jcfg"], s["cfg"]
    batch = _batch(cfg, 16)
    del batch["labels"], batch["mask"]
    Tv, S = 8, 8
    jb, tb = _both(batch)
    jmerged = J_MERGE(s["jparams"], s["jfull"], jcfg)
    state = jax_decode.make_prefill_fn(jcfg)(jmerged, jb, JT.init_cache(jcfg, B, Tv + S + 1))
    assert int(state.pos) == S
    _, jlogits = jax_decode.make_decode_fn(jcfg)(jmerged, state)
    jfwd, _ = J_FORWARD(jmerged, dict(jb, tokens=jnp.concatenate([jb["tokens"], state.tokens],
                                                                  axis=1)), jcfg)
    gap = float(np.max(np.abs(np.asarray(jlogits[:, -1]) - np.asarray(jfwd[:, -1]))))
    assert gap > 1e-3 * float(np.max(np.abs(np.asarray(jfwd[:, -1])))), gap
    with torch.no_grad():
        st = make_prefill_fn(cfg)(s["params"], tb, T.init_cache(cfg, B, Tv + S + 1,
                                                                device="cpu"), s["full"])
        assert st.pos == Tv + S
        _, logits = make_decode_fn(cfg)(s["params"], st, lora=s["full"])
        fwd = T.forward(s["params"], dict(tb, tokens=torch.cat([tb["tokens"], st.tokens], 1)),
                        cfg, lora=s["full"])
    _close(logits[:, -1], fwd[:, -1], ONE_PASS, "first decode step vs forward")
    _close(fwd, jfwd, ONE_PASS, "forward")
    # decode_tokens: its cache holds Tv + S + max_new positions
    got = decode_tokens(s["params"], cfg, tb["tokens"], 3, lora=s["full"], device="cpu",
                        inputs={"vision_embeds": tb["vision_embeds"]})
    assert got[:, :2].tolist() == torch.cat([st.tokens, logits[:, -1:].argmax(-1)], 1).tolist()


def test_prefill_routes_through_flash_causal(monkeypatch):
    """With ``kernels=True`` the prefill calls the flash wrapper once a
    layer, causal over the Tv + S positions, and every adapted projection
    calls the LoRA wrapper; the projector runs plain products. On the CPU
    the wrappers run their plain versions: no kernel launches."""
    s = _setup()
    cfg = s["cfg"]
    calls, real = [], L.flash_attention

    def record(q, k, v, **kw):
        calls.append((kw["causal"], q.shape[2], k.shape[2]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(L, "flash_attention", record)
    flash_attention.launches = lora_matmul.launches = 0
    _, tb = _both(_batch(cfg, 16))
    with torch.no_grad():
        T.prefill(s["params"], tb, cfg, T.init_cache(cfg, B, 17, device="cpu"), lora=s["full"])
    assert calls == [(True, 16, 16)] * cfg.num_layers
    assert flash_attention.launches == lora_matmul.launches == 0


# ---------------------------------------------------------------------------
# split learning
# ---------------------------------------------------------------------------


def test_split_value_and_grad_matches_reference():
    """Loss and every adapter-gradient leaf of one split pass at cut=1 (the
    projector on the client, the activations over Tv + S positions) against
    the reference's; split == monolithic inside the port; the info dict."""
    s = _setup()
    cfg = s["cfg"]
    jb, tb = _both(_batch(cfg, 16))
    jloss, jdc, jds, jinfo = J_SPLIT(s["jparams"], s["jlc"], s["jls"], jb, s["jcfg"], 1)
    loss, dc, ds, info = split.split_value_and_grad(s["params"], s["lc"], s["ls"], tb, cfg, 1)
    _close(loss, jloss, ONE_PASS, "loss")
    _close_lora(dc, jdc, ONE_PASS, "dlora_c")
    _close_lora(ds, jds, ONE_PASS, "dlora_s")
    assert info == {k: int(v) for k, v in jinfo.items()}
    assert info["smashed_bytes"] == 4 * B * 16 * cfg.d_model
    mloss, mdc, mds = split.monolithic_value_and_grad(s["params"], s["lc"], s["ls"], tb, cfg, 1)
    _close(mloss, loss, 1e-6, "monolithic loss")
    for got, want in ((mdc, dc), (mds, ds)):
        for k in want:
            for n in ("A", "B"):
                _close(got[k][n], want[k][n], ONE_PASS, f"monolithic {k} {n}")


def test_round_fn_matches_reference():
    """One build_round_fn round of llava smoke (gd, K=2 clients of 2 x 16
    positions, 8 of them patches, I_loc = 2) from the same state: metrics
    and the new adapters within 1e-4 of the largest value per leaf."""
    s = _setup()
    jcfg, cfg = s["jcfg"], s["cfg"]
    K = 2
    batches = _batch(cfg, 16, seed=7, lead=(K, B))
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
