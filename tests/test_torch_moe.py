"""The port's MoE family (olmoe-1b-7b, qwen3-moe-235b-a22b) against the
reference, on the CPU.

Each config runs as its smoke variant in fp32 (``smoke_variant``: 2 layers,
d_model 64, 8 experts top-2, head dim 16, vocab 256; olmoe MHA 4/4, qwen3
GQA 4/2, both with ``qk_norm``). Parameters and adapters of the reference's
tree (the experts' adapters stacked (groups, E, d_in, r)) are drawn with
numpy and handed to both libraries (the port's through
``repro_torch.bridge``), norm scales (the q/k norms' too) away from 1.

Tolerance: 1e-5 of the largest value compared (per leaf of a tree), the
same fp32 function summed in another order by the two libraries; the aux
loss within 1e-6; 1e-4 for a whole round (``test_torch_train.py``'s
``ROUND``). Routing is compared by name first (the top-k expert sets and
every pair's slot), so a tie shows up as itself and not as a large output
gap.
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
from repro.models import moe as JMOE
from repro.models import registry as jax_registry
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.config import FedsLLMConfig, LoRAConfig, get_arch, smoke_variant
from repro_torch.core import fedsllm, split
from repro_torch.core import lora as torch_lora
from repro_torch.models import moe as MOE
from repro_torch.models import registry
from repro_torch.models import transformer as T

ARCHS = ["olmoe-1b-7b", "qwen3-moe-235b-a22b"]
ONE_PASS = 1e-5
AUX = 1e-6
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


def _configs(arch):
    jcfg = jax_smoke_variant(jax_get_arch(arch)).replace(lora=JaxLoRAConfig(rank=4, alpha=8.0))
    cfg = smoke_variant(get_arch(arch)).replace(lora=LoRAConfig(rank=4, alpha=8.0))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _draw(tree, rng):
    """numpy values for the reference's abstract tree: weights N(0, 0.05²),
    norm scales 1 + N(0, 0.05²), LoRA A ~ N(0, 1)/4 and B ~ N(0, 0.05²)
    (B = 0 would hide the adapters)."""
    def one(path, leaf):
        name = getattr(path[-1], "key", "")
        v = rng.standard_normal(leaf.shape)
        v = v / 4 if name == "A" else 0.05 * v + (name in ("scale", "q_norm", "k_norm"))
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


@functools.lru_cache(maxsize=None)
def _setup(arch, cut=1):
    """Parameters and adapters of the reference's tree, drawn with numpy
    (``_draw``), in both libraries; adapters cut after group ``cut``."""
    jcfg, cfg = _configs(arch)
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
# the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,router_norm,skew", [
    ("olmoe-1b-7b", True, 0.0), ("qwen3-moe-235b-a22b", True, 0.0),
    ("olmoe-1b-7b", False, 0.0),
    ("olmoe-1b-7b", True, 3.0),  # expert 0 wanted by every token: capacity drops
])
def test_apply_moe_matches_reference(arch, router_norm, skew):
    """Routing, slots, output and aux of one MoE layer (B=2, S=24) against
    the reference's local path: the top-k expert sets equal by name, every
    pair's dest/keep equal, outputs within 1e-5, aux within 1e-6."""
    jcfg, cfg = _configs(arch)
    jcfg, cfg = jcfg.replace(moe_router_norm=router_norm), cfg.replace(moe_router_norm=router_norm)
    S = 24
    rng = np.random.default_rng(4)
    p = {k: np.array(v[0]) for k, v in _setup(arch)["jparams"]["groups"]["sub_0"]["moe"].items()}
    p["router"][:, 0] += skew
    x = (rng.standard_normal((B, S, cfg.d_model)) + (skew > 0)).astype(np.float32)
    tp = bridge.params_from_numpy(p, device="cpu")
    tx = torch.from_numpy(x)
    jy, jaux = jax.jit(JMOE.apply_moe, static_argnums=2)(p, jnp.asarray(x), jcfg)
    y, aux = MOE.apply_moe(tp, tx, cfg)
    top_w, top_e, _ = MOE.route(tp, tx, cfg)
    jlogits = np.einsum("bsd,de->bse", x, p["router"])
    jtop = np.asarray(jax.lax.top_k(jnp.asarray(jlogits), cfg.num_experts_per_tok)[1])
    assert [set(r) for r in top_e.reshape(-1, 2).tolist()] == \
        [set(r) for r in jtop.reshape(-1, 2).tolist()]
    C = MOE.expert_capacity(S, cfg)
    assert C == JMOE.expert_capacity(S, jcfg)
    dest, keep = MOE._rank_and_dest(top_e, cfg.num_experts, C, cfg.num_experts_per_tok)
    jdest, jkeep = JMOE._rank_and_dest(jnp.asarray(jtop), cfg.num_experts, C,
                                       cfg.num_experts_per_tok)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if skew:  # every token wants expert 0: it keeps C pairs a row, the rest drop
        assert bool((~keep).any())
        assert ((dest < C) & keep).sum(1).tolist() == [C] * B
    _close(y, jy, ONE_PASS, "moe output")
    _close(aux, jaux["moe_aux_loss"], AUX, "aux")


def test_expert_adapters_match_the_merged_experts():
    """The experts' unmerged adapters (A (E, D, r), B (E, r, F) per group,
    the serving path) give the merged weights' output."""
    s = _setup("olmoe-1b-7b")
    cfg = s["cfg"]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((B, 16, cfg.d_model))
                         .astype(np.float32))
    gp = {k: v[0] for k, v in s["params"]["groups"]["sub_0"]["moe"].items()}
    ad = torch_lora.layer_adapters(s["full"], cfg, 0)["sub_0"]["moe"]
    assert ad["w_gate"][0].shape == (cfg.num_experts, cfg.d_model, 4)
    merged = torch_lora.merge(s["params"], s["full"], cfg)
    mp = {k: v[0] for k, v in merged["groups"]["sub_0"]["moe"].items()}
    served, _ = MOE.apply_moe(gp, x, cfg, adapters=ad)
    plain, _ = MOE.apply_moe(mp, x, cfg)
    _close(served, plain, ONE_PASS, "served vs merged")


# ---------------------------------------------------------------------------
# forward, loss, serving, split gradients, a round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    """Logits of the plain path (merged weights), of the serving path (the
    adapters unmerged) and the training loss with its aux term, against the
    reference's forward and loss_fn."""
    s = _setup(arch)
    batch = _batch(s["cfg"], 48)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmerged = J_MERGE(s["jparams"], s["jfull"], s["jcfg"])
    jlogits, jaux = J_FORWARD(jmerged, jb, s["jcfg"])
    jloss, jm = J_LOSS(jmerged, jb, s["jcfg"])
    tb = bridge.batches_from_numpy(batch, device="cpu")
    merged = torch_lora.merge(s["params"], s["full"], s["cfg"])
    with torch.no_grad():
        plain = T.forward(merged, tb, s["cfg"], kernels=False)
        served = T.forward(s["params"], tb, s["cfg"], lora=s["full"])
        loss, m = T.loss_fn(merged, tb, s["cfg"])
    _close(plain, jlogits, ONE_PASS, "plain logits")
    _close(served, jlogits, ONE_PASS, "served logits")
    _close(loss, jloss, ONE_PASS, "loss")
    _close(m["ce_loss"], jm["ce_loss"], ONE_PASS, "ce")
    _close(m["moe_aux"], jm["moe_aux"], AUX, "aux")
    assert float(m["moe_aux"]) > 1.0  # E·Σ me·ce >= 1 for every routing


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill (S=16) plus 4 decode steps (teacher-forced tokens) through
    the serving path against the reference's prefill and decode_step on
    merged weights: the q/k norms run on both paths before RoPE and the
    cache write, and decode routes each single token with capacity 8."""
    s = _setup(arch)
    jcfg, cfg = s["jcfg"], s["cfg"]
    S = 16
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 4), dtype=np.int32)
    jmerged = J_MERGE(s["jparams"], s["jfull"], jcfg)
    jcache = JT.init_cache(jcfg, B, S + 8)
    jlogits, jcache = J_PREFILL(jmerged, {"tokens": jnp.asarray(toks[:, :S])}, jcfg, jcache)
    t = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        cache = T.init_cache(cfg, B, S + 8, device="cpu")
        logits, cache = T.prefill(s["params"], {"tokens": t[:, :S]}, cfg, cache, lora=s["full"])
        _close(logits, jlogits, ONE_PASS, "prefill")
        _close(cache["groups"]["sub_0"]["attn"][0], jcache["groups"]["sub_0"]["attn"][0],
               ONE_PASS, "normed, rotated keys in the cache")
        for pos in range(S, S + 4):
            jstep, jcache = J_DECODE(jmerged, jnp.asarray(toks[:, pos - 1:pos]), jcache,
                                     jnp.asarray(pos - 1, jnp.int32), jcfg)
            step, cache = T.decode_step(s["params"], t[:, pos - 1:pos], cache, pos - 1, cfg,
                                        lora=s["full"])
            _close(step, jstep, ONE_PASS, f"decode at {pos - 1}")


@pytest.mark.parametrize("arch", ARCHS)
def test_split_value_and_grad_matches_reference(arch):
    """Loss and every adapter-gradient leaf (the experts' stacked adapters
    among them) of one split pass at cut=1 against the reference's; split
    == monolithic inside the port; and the split loss is loss_fn's less
    0.01 × the client group's aux: the reference's client_forward drops the
    client's aux loss (ROADMAP.md §3), and the port does as it does."""
    s = _setup(arch)
    cfg = s["cfg"]
    batch = _batch(cfg, 48)
    jloss, jdc, jds, jinfo = J_SPLIT(
        s["jparams"], s["jlc"], s["jls"], {k: jnp.asarray(v) for k, v in batch.items()},
        s["jcfg"], 1)
    tb = bridge.batches_from_numpy(batch, device="cpu")
    loss, dc, ds, info = split.split_value_and_grad(s["params"], s["lc"], s["ls"], tb, cfg, 1)
    _close(loss, jloss, ONE_PASS, "loss")
    _close_lora(dc, jdc, ONE_PASS, "dlora_c")
    _close_lora(ds, jds, ONE_PASS, "dlora_s")
    assert any("moe" in k for k in dc)
    assert info == {k: int(v) for k, v in jinfo.items()}
    mloss, mdc, mds = split.monolithic_value_and_grad(s["params"], s["lc"], s["ls"], tb, cfg, 1)
    _close(mloss, loss, 1e-6, "monolithic loss")
    for got, want in ((mdc, dc), (mds, ds)):
        for k in want:
            for n in ("A", "B"):
                _close(got[k][n], want[k][n], ONE_PASS, f"monolithic {k} {n}")
    with torch.no_grad():
        merged = torch_lora.merge(s["params"], s["full"], cfg)
        full_loss, _ = T.loss_fn(merged, tb, cfg)
        client = split.slice_base(merged, 1).client_base
        x, positions = T._embed_inputs(client, tb, cfg)
        _, client_aux = T._scan_groups(client, x, cfg, positions=positions, kernels=False,
                                       include_tail=False)
    assert float(client_aux) > 1.0
    _close(full_loss - loss, 0.01 * client_aux, 1e-4, "loss_fn - split loss")


def test_round_fn_matches_reference():
    """One build_round_fn round of olmoe smoke (gd, K=2 clients of 2 x 32
    tokens, I_loc = 2) from the same state: metrics and the new adapters
    within 1e-4 of the largest value per leaf."""
    s = _setup("olmoe-1b-7b")
    jcfg, cfg = s["jcfg"], s["cfg"]
    K, S = 2, 32
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
# parameter counts, structure, what is still unported
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_param_counts_match_reference(arch, smoke):
    """count_params (the element count of init_params on the meta device:
    router and q/k norms included), active_param_count and the adapter
    count (the experts' stacked adapters included) equal the reference's,
    at full size (olmoe 6.9 B, qwen3 235 B) and smoke size."""
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    if smoke:
        jcfg, cfg = jax_smoke_variant(jcfg), smoke_variant(cfg)
    assert registry.count_params(cfg) == jax_registry.count_params(jcfg)
    assert registry.active_param_count(cfg) == jax_registry.active_param_count(jcfg)
    assert torch_lora.lora_param_count(cfg) == jax_lora.lora_param_count(jcfg)
    assert registry.count_params(cfg, trainable_only=True) == jax_lora.lora_param_count(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """The same leaves, shapes and adapter key strings as the reference's
    tree: the fp32 router, the stacked experts, the q/k norms."""
    jcfg, cfg = _configs(arch)
    jparams, axes = JT.init_params(jcfg, abstract=True)
    params = T.init_params(cfg, device="cpu")
    shapes = lambda tree: {jax.tree_util.keystr(p): tuple(v.shape)  # noqa: E731
                           for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(params) == shapes(jparams)
    assert params["groups"]["sub_0"]["moe"]["router"].dtype == torch.float32
    bf = T.init_params(cfg.replace(param_dtype="bfloat16"), device="meta")
    assert bf["groups"]["sub_0"]["moe"]["router"].dtype == torch.float32
    assert bf["groups"]["sub_0"]["moe"]["w_up"].dtype == torch.bfloat16
    jfull, _ = jax_lora.init_lora(jparams, axes, jcfg, abstract=True)
    assert set(torch_lora.init_lora(params, cfg, device="cpu")) == set(jfull)


@pytest.mark.parametrize("family,pattern", [("encdec", "LG"), ("vlm", "M")])
def test_unported_families_still_raise(family, pattern):
    """encdec and vlm run with the pattern ``G`` only (``PORTED``): any other
    pattern of theirs still raises."""
    cfg = smoke_variant(get_arch("olmoe-1b-7b")).replace(family=family, layer_pattern=pattern)
    with pytest.raises(NotImplementedError):
        T.init_params(cfg, device="cpu")


def test_api_registry_reexports_the_registry():
    """``repro_torch.api.registry`` names the same object as
    ``repro_torch.registry``, as the reference's back-compat module does."""
    from repro.api import registry as jax_api_registry
    from repro_torch import registry as torch_registry
    from repro_torch.api import registry as api_registry

    assert api_registry.__all__ == jax_api_registry.__all__ == ["Registry"]
    assert api_registry.Registry is torch_registry.Registry
