"""The port's training slice (one FedsLLM global round) against the reference.

Inputs come from the reference (its parameters, adapters, state and token
batches, bridged through ``repro_torch.bridge``) or from numpy seeds; nothing
is re-drawn on the torch side, since ``jax.random`` cannot be reproduced
there. Smoke variants in fp32: ``smoke_variant(fedsllm-100m)`` (2 dense
layers, d_model 64) and ``smoke_variant(mamba2-130m)`` (2 SSM layers).

Tolerances, each relative to the largest value of what is compared (per
leaf of a tree):
  * 1e-5 for one forward/backward (the CE, the loss, split gradients): the
    same fp32 function, summed in another order by the two libraries;
  * 1e-4 for whole rounds (I_loc = 2 local steps of 3 clients, two rounds):
    those errors carried through the updates (the test prints the largest
    gap it saw; 5e-6 for gd and fedprox, 1.2e-5 for scaffold when written);
  * 1e-6 for the aggregators and ``apply_update`` (one reduction);
  * bit-identical for the numpy code (delay model, sampling, masks).

The full-width model trains in bfloat16, so the round is also held in
bfloat16: its own arithmetic bit for bit (with a split gradient both
libraries compute exactly), and with the model, at limits set from the
measured gaps (each test says which).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.aggregators import get_aggregator as jax_get_aggregator
from repro.config import FedsLLMConfig as JaxFedsLLMConfig
from repro.config import LoRAConfig as JaxLoRAConfig
from repro.config import get_arch as jax_get_arch
from repro.config import smoke_variant as jax_smoke_variant
from repro.core import delay_model as jax_dm
from repro.core import federated as jax_federated
from repro.core import fedsllm as JF
from repro.core import lora as jax_lora
from repro.core import split as jax_split
from repro.data.tokens import TokenStream as JaxTokenStream
from repro.data.tokens import client_batches as jax_client_batches
from repro.fl.local_algos import get_local_algo as jax_get_local_algo
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.api import aggregators, allocators
from repro_torch.config import FedsLLMConfig, LoRAConfig, get_arch, smoke_variant
from repro_torch.core import delay_model as dm
from repro_torch.core import federated, fedsllm, split
from repro_torch.core import lora as torch_lora
from repro_torch.data.tokens import PERM_SEED, TokenStream, client_batches
from repro_torch.fl import local_algos
from repro_torch.kernels.attn_ops import flash_attention
from repro_torch.kernels.lora_ops import lora_matmul
from repro_torch.kernels.ssd_ops import ssd_scan
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.net import topology
from repro_torch.sim import scenario
from repro_torch.tree import tree_leaves, tree_map

ONE_PASS = 1e-5
ROUND = 1e-4
AGG = 1e-6
B, S = 2, 16
ETA = 0.9  # I_loc = 2 (Lemma 2 with the paper's δ = 0.1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _err(got, want) -> tuple[float, float]:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want), initial=0.0)), float(np.max(np.abs(want), initial=0.0))


def _close(got, want, tol, what=""):
    err, scale = _err(got, want)
    assert err <= tol * max(scale, 1e-30), f"{what}: {err:.3e} > {tol} x {scale:.3e}"
    return err / max(scale, 1e-30)


def _close_lora(got, want, tol, what=""):
    """Adapters (or their gradients) leaf by leaf: got from the port, want
    from the reference; the same key strings."""
    want = jax.device_get(want)
    assert set(got) == set(want), (sorted(got), sorted(want))
    return max(_close(got[k][n], want[k][n], tol, f"{what} {k} {n}")
               for k in want for n in ("A", "B"))


def _configs(arch, **lora):
    jcfg = jax_smoke_variant(jax_get_arch(arch))
    cfg = smoke_variant(get_arch(arch))
    if lora:
        jcfg, cfg = jcfg.replace(lora=JaxLoRAConfig(**lora)), cfg.replace(lora=LoRAConfig(**lora))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _split_setup(arch, cut=1):
    """tests/test_split.py's setup: rank 4, B made non-zero, B=2, S=16."""
    jcfg, cfg = _configs(arch, rank=4, alpha=8.0)
    params, axes = JT.init_params(jcfg, key=jax.random.PRNGKey(0))
    full, _ = jax_lora.init_lora(params, axes, jcfg, key=jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    full = {k: {n: v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
                for n, v in ab.items()} for k, ab in jax.device_get(full).items()}
    lc, ls = jax_lora.split_client_server(full, cut)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    return dict(jcfg=jcfg, cfg=cfg, jparams=params, jlc=lc, jls=ls, jbatch=batch,
                params=bridge.params_from_numpy(jax.device_get(params), device="cpu"),
                lc=bridge.lora_from_numpy(jax.device_get(lc), device="cpu"),
                ls=bridge.lora_from_numpy(jax.device_get(ls), device="cpu"),
                batch=bridge.batches_from_numpy(batch, device="cpu"))


@pytest.fixture(scope="module", params=["fedsllm-100m", "mamba2-130m"])
def split_setup(request):
    return _split_setup(request.param)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,chunk,masked,tied", [(20, 8, True, False), (16, 8, False, False),
                                                   (20, 256, True, True)])
def test_fused_cross_entropy_matches_reference(seq, chunk, masked, tied):
    """Value and gradients (x, head) of the chunked CE, and the plain CE, with
    a mask and an S that is not a multiple of the chunk."""
    jcfg, cfg = _configs("fedsllm-100m")
    jcfg, cfg = jcfg.replace(tie_embeddings=tied), cfg.replace(tie_embeddings=tied)
    rng = np.random.default_rng(seq + chunk)
    x = rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32)
    w = (0.1 * rng.standard_normal((cfg.vocab_size, cfg.d_model) if tied
                                   else (cfg.d_model, cfg.vocab_size))).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, seq), dtype=np.int32)
    mask = (rng.random((B, seq)) < 0.7).astype(np.float32) if masked else None
    key = "tokens" if tied else "head"

    def jloss(x, w):
        return JL.fused_cross_entropy({key: w}, x, jnp.asarray(labels), jcfg,
                                      mask=None if mask is None else jnp.asarray(mask),
                                      chunk=chunk)

    jval, (jdx, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tmask = None if mask is None else torch.from_numpy(mask)
    val = L.fused_cross_entropy({key: tw}, tx, torch.from_numpy(labels).long(), cfg,
                                mask=tmask, chunk=chunk)
    dx, dw = torch.autograd.grad(val, [tx, tw])
    _close(val, jval, ONE_PASS, "loss")
    _close(dx, jdx, ONE_PASS, "dx")
    _close(dw, jdw, ONE_PASS, "dw")
    logits = tx.detach() @ (tw.detach().T if tied else tw.detach())
    jlogits = jnp.asarray(x) @ (jnp.asarray(w).T if tied else jnp.asarray(w))
    _close(L.cross_entropy(logits, torch.from_numpy(labels), tmask),
           JL.cross_entropy(jlogits, jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask)), ONE_PASS, "ce")


def test_loss_fn_matches_reference(split_setup):
    """T.loss_fn and its gradient with respect to every base parameter."""
    s = split_setup
    jbatch = {k: jnp.asarray(v) for k, v in s["jbatch"].items()}
    (jval, jaux), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jbatch, s["jcfg"]), has_aux=True)(s["jparams"])
    params = tree_map(lambda t: t.clone().requires_grad_(), s["params"])
    val, aux = T.loss_fn(params, s["batch"], s["cfg"])
    grads = torch.autograd.grad(val, tree_leaves(params))
    _close(val, jval, ONE_PASS, "loss")
    _close(aux["ce_loss"], jaux["ce_loss"], ONE_PASS, "ce_loss")
    for (path, jg), g in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                             _leaves_by_reference_order(params, grads)):
        _close(g, jg, ONE_PASS, jax.tree_util.keystr(path))


def _leaves_by_reference_order(tree, leaves):
    """``leaves`` (in the port tree's order) re-ordered as JAX flattens the
    same tree: dict keys sorted."""
    paths = []

    def walk(t, p):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, p + (k,))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, p + (i,))
        else:
            paths.append(p)

    walk(tree, ())
    by_path = dict(zip(paths, leaves))
    return [by_path[p] for p in sorted(paths)]


def test_scan_groups_on_views_equals_the_whole_stack(split_setup):
    """Repair: a client view groups[:cut] then a server view groups[cut:]
    gives the whole stack's output (the loop follows the stack it is
    given), each view with the adapters cut to its layers."""
    s = split_setup
    cfg, params = s["cfg"], s["params"]
    full = torch_lora.join_client_server(s["lc"], s["ls"])
    x, positions = T._embed_inputs(params, s["batch"], cfg)
    whole = T._scan_groups(params, x, cfg, positions=positions, lora=full, kernels=False)
    parts = split.slice_base(params, 1)
    lc, ls = torch_lora.split_client_server(full, 1)
    h = T._scan_groups(parts.client_base, x, cfg, positions=positions, lora=lc, kernels=False)
    h = T._scan_groups(parts.server_base, h, cfg, positions=positions, lora=ls, kernels=False)
    torch.testing.assert_close(h, whole, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# LoRA cut and the split engine
# ---------------------------------------------------------------------------


def test_split_join_client_server_match_reference(split_setup):
    s = split_setup
    full = torch_lora.join_client_server(s["lc"], s["ls"])
    jfull = jax_lora.join_client_server(s["jlc"], s["jls"])
    _close_lora(full, jfull, 0.0, "join")
    lc, ls = torch_lora.split_client_server(full, 1)
    jlc, jls = jax_lora.split_client_server(jfull, 1)
    assert (set(lc), set(ls)) == (set(jlc), set(jls))
    _close_lora(lc, s["jlc"], 0.0, "client")
    _close_lora(ls, s["jls"], 0.0, "server")
    _close(torch_lora.delta_norm(full), jax_lora.delta_norm(jfull), AGG, "delta_norm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_matches_reference(split_setup, dtype):
    """W + scale·A·B formed in fp32 and cast to W's dtype: bit-identical to
    the reference's in bfloat16, within 1e-6 in fp32 (the A·B sums)."""
    s = split_setup
    jcfg, cfg = (c.replace(dtype=dtype, param_dtype=dtype) for c in (s["jcfg"], s["cfg"]))
    jparams = jax.tree.map(lambda a: a.astype(dtype), s["jparams"])
    jfull = jax.tree.map(lambda a: a.astype(dtype),
                         jax_lora.join_client_server(s["jlc"], s["jls"]))
    want = jax_lora.merge(jparams, jfull, jcfg)
    got = torch_lora.merge(bridge.params_from_numpy(jax.device_get(jparams), device="cpu"),
                           bridge.lora_from_numpy(jax.device_get(jfull), device="cpu"), cfg)
    _same_dtypes(got, want)
    tol = 0.0 if dtype == "bfloat16" else AGG
    for g, w in zip(_leaves_by_reference_order(got, tree_leaves(got)), jax.tree.leaves(want)):
        _close(g, w, tol, f"merge {dtype}")


@pytest.mark.parametrize("arch", ["fedsllm-100m", "mamba2-130m"])
@pytest.mark.parametrize("smoke", [True, False])
def test_lora_param_count_matches_reference(arch, smoke):
    """Computed from shapes (the meta device), so the full configs cost nothing."""
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    if smoke:
        jcfg, cfg = jax_smoke_variant(jcfg), smoke_variant(cfg)
    assert torch_lora.lora_param_count(cfg) == jax_lora.lora_param_count(jcfg)


def test_split_value_and_grad_matches_reference(split_setup):
    """Loss, every leaf of dlora_c / dlora_s and the info byte counts against
    the reference; split == monolithic inside the port."""
    s = split_setup
    jbatch = {k: jnp.asarray(v) for k, v in s["jbatch"].items()}
    jloss, jdc, jds, jinfo = jax_split.split_value_and_grad(s["jparams"], s["jlc"], s["jls"],
                                                            jbatch, s["jcfg"], 1)
    loss, dc, ds, info = split.split_value_and_grad(s["params"], s["lc"], s["ls"], s["batch"],
                                                    s["cfg"], 1)
    _close(loss, jloss, ONE_PASS, "loss")
    _close_lora(dc, jdc, ONE_PASS, "dlora_c")
    _close_lora(ds, jds, ONE_PASS, "dlora_s")
    assert info == {k: int(v) for k, v in jinfo.items()}
    mloss, mdc, mds = split.monolithic_value_and_grad(s["params"], s["lc"], s["ls"], s["batch"],
                                                      s["cfg"], 1)
    _close(mloss, loss, 1e-6, "monolithic loss")
    for got, want in ((mdc, dc), (mds, ds)):
        for k in want:
            for n in ("A", "B"):
                _close(got[k][n], want[k][n], ONE_PASS, f"monolithic {k} {n}")
    # the adapters passed in are left as they were
    assert not any(t.requires_grad for t in tree_leaves((s["lc"], s["ls"])))


# ---------------------------------------------------------------------------
# aggregation and local algorithms
# ---------------------------------------------------------------------------


def _stacked(K, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((K, 3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((K, 5)).astype(np.float32)}}


@pytest.mark.parametrize("name", ["fedavg", "weighted", "median", "trimmed_mean", "staleness"])
@pytest.mark.parametrize("K,weighted,mask", [(4, False, None), (5, True, None),
                                             (5, True, (1, 0, 1, 1, 0)), (4, False, (0, 1, 1, 1)),
                                             (3, True, (0, 0, 0))])
def test_aggregators_match_reference(name, K, weighted, mask):
    """Every registered aggregator, with weights and masks (no survivor
    included), then apply_update with a scale, within 1e-6."""
    tree = _stacked(K, K)
    rng = np.random.default_rng(K + 1)
    w = rng.uniform(0.5, 3.0, K).astype(np.float32) if weighted else None
    m = None if mask is None else np.asarray(mask, np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    got = aggregators.get_aggregator(name)(tree_map(torch.from_numpy, tree), weights=t(w),
                                           mask=t(m))
    want = jax_get_aggregator(name)(tree, weights=j(w), mask=j(m))
    _close(got["a"], want["a"], AGG, name)
    _close(got["b"]["c"], want["b"]["c"], AGG, name)
    base = {"a": np.ones((3, 4), np.float32), "b": {"c": np.arange(5, dtype=np.float32)}}
    new = federated.apply_update(tree_map(torch.from_numpy, base), got, 0.5)
    jnew = jax_federated.apply_update(base, want, 0.5)
    _close(new["a"], jnew["a"], AGG, "apply_update")
    _close(new["b"]["c"], jnew["b"]["c"], AGG, "apply_update")


def test_staleness_weighted_and_broadcast_match_reference():
    tree = _stacked(4, 9)
    st = np.array([0.0, 1.0, 3.0, 7.0], np.float32)
    w = np.array([1.0, 2.0, 1.0, 4.0], np.float32)
    got = federated.staleness_weighted(tree_map(torch.from_numpy, tree), torch.from_numpy(w),
                                       staleness=torch.from_numpy(st), beta=0.7)
    want = jax_federated.staleness_weighted(tree, jnp.asarray(w), staleness=jnp.asarray(st),
                                            beta=0.7)
    _close(got["a"], want["a"], AGG, "staleness")
    np.testing.assert_array_equal(federated.staleness_discount(st, 0.7),
                                  jax_federated.staleness_discount(st, 0.7))
    b = federated.broadcast({"w": torch.ones(3)}, 5)
    assert b["w"].shape == (5, 3) and jax_federated.broadcast({"w": jnp.ones(3)}, 5)["w"].shape \
        == (5, 3)


@pytest.mark.parametrize("num_clients,cohort", [(10, 4), (64, 64), (500, 12), (10_000, 7)])
def test_client_sample_and_deadline_mask_bit_identical(num_clients, cohort):
    for r in range(3):
        np.testing.assert_array_equal(federated.client_sample(r, num_clients, cohort, seed=5),
                                      jax_federated.client_sample(r, num_clients, cohort, seed=5))
    T_k = np.random.default_rng(num_clients).uniform(0.1, 10.0, cohort)
    np.testing.assert_array_equal(federated.deadline_mask(T_k, 5.0),
                                  jax_federated.deadline_mask(T_k, 5.0))


@pytest.mark.parametrize("name,kw", [("gd", {}), ("fedprox", {"mu": 0.3}), ("scaffold", {})])
def test_local_algo_correct_matches_reference(name, kw):
    rng = np.random.default_rng(3)
    mk = lambda: (_stacked(1, int(rng.integers(100)))["b"],
                  _stacked(1, int(rng.integers(100)))["a"])
    g, h, ctrl, cbar = mk(), mk(), mk(), mk()
    to_t = lambda tree: tree_map(torch.from_numpy, tree)
    got = local_algos.get_local_algo(name, **kw).correct(to_t(g), to_t(h), to_t(ctrl), to_t(cbar))
    want = jax_get_local_algo(name, **kw).correct(g, h, ctrl, cbar)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        _close(a, b, AGG, name)
    if name == "fedprox":  # μ = 0 is gd
        zero = local_algos.get_local_algo("fedprox", mu=0.0).correct(to_t(g), to_t(h), None, None)
        for a, b in zip(tree_leaves(zero), tree_leaves(to_t(g))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("registry,name", [("aggregators", "fedsum"), ("local_algos", "adam"),
                                           ("scenarios", "rayleigh"), ("topologies", "mesh"),
                                           ("allocators", "greedy")])
def test_unknown_names_raise_listing_the_known(registry, name):
    reg = {"aggregators": aggregators.aggregators, "local_algos": local_algos.local_algos,
           "scenarios": scenario.scenarios, "topologies": topology.topologies,
           "allocators": allocators.allocators}[registry]
    with pytest.raises(KeyError, match="known"):
        reg.get(name)


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------

K_ROUND = 3
# two rounds: the first from the initial state (B = 0, so dA = 0), the second
# from the first's result with a straggler masked out, D_k weights and a
# server mixing rate. The first passes the neutral values (all ones) rather
# than None, so that the reference compiles one round function, not two.
ROUNDS = [dict(mask=(1.0, 1.0, 1.0), weights=(1.0, 1.0, 1.0), update_scale=1.0),
          dict(mask=(1.0, 0.0, 1.0), weights=(3.0, 1.0, 2.0), update_scale=0.5)]
ALGOS = [("gd", {}), ("fedprox", {"mu": 0.3}), ("scaffold", {})]
SCAFFOLD_POPULATION, SCAFFOLD_IDS = 5, (4, 0, 2)


def _round_setup(dtype="float32"):
    jcfg, cfg = _configs("fedsllm-100m")
    jcfg, cfg = (c.replace(dtype=dtype, param_dtype=dtype) for c in (jcfg, cfg))
    jstate, _ = JF.init_state(jcfg, cut=1, key=jax.random.PRNGKey(0))
    stream = JaxTokenStream(B, S, cfg.vocab_size, seed=0)
    jbatches = [jax_client_batches(stream, r, K_ROUND) for r in range(len(ROUNDS))]
    return dict(jcfg=jcfg, cfg=cfg, jstate=jstate, jbatches=jbatches,
                state=bridge.state_from_numpy(*jax.device_get(tuple(jstate)), device="cpu"),
                batches=[bridge.batches_from_numpy(jax.device_get(b), device="cpu")
                         for b in jbatches])


@pytest.fixture(scope="module")
def round_setup():
    return _round_setup()


@pytest.fixture(scope="module")
def round_setup_bf16():
    """The same rounds in bfloat16, the full-width model's dtype."""
    return _round_setup("bfloat16")


def _round_fns(s, name, kw, exact=False):
    """The reference's round function (jitted) and the port's. ``exact``:
    XLA rounds every bfloat16 operation to bfloat16, as torch does, instead
    of keeping fused chains in fp32 (its default excess precision)."""
    jalgo = jax_get_local_algo(name, **kw)
    jfn = jax.jit(JF.build_round_fn(s["jcfg"], JaxFedsLLMConfig(num_clients=K_ROUND), 1, ETA,
                                    local_algo=jalgo))
    if exact:
        opts = {"xla_allow_excess_precision": False}
        jitted = jfn
        jfn = lambda *a: jitted.lower(*a).compile(compiler_options=opts)(*a)  # noqa: E731
    fn = fedsllm.build_round_fn(s["cfg"], FedsLLMConfig(num_clients=K_ROUND), 1, ETA,
                                local_algo=local_algos.get_local_algo(name, **kw))
    return jalgo, jfn, fn


@pytest.fixture(scope="module", params=ALGOS, ids=[a for a, _ in ALGOS])
def round_pair(request, round_setup):
    """The reference's round function (jitted once per algorithm) and the port's."""
    name, kw = request.param
    return (name,) + _round_fns(round_setup, name, kw)


def _rounds(s, jalgo, jfn, fn):
    """Both round functions through ROUNDS from the same state. Yields, per
    round: (previous port state, port state, metrics, variates) and the
    reference's four (variates None unless the algorithm is stateful)."""
    jstate, state = s["jstate"], s["state"]
    jvar = var = None
    if jalgo.stateful:
        jvar = jalgo.init_variates((jstate.lora_c, jstate.lora_s), SCAFFOLD_POPULATION)
        var = tree_map(lambda a: bridge.tensor_from_numpy(a, device="cpu"), jax.device_get(jvar))
    for r, kw in enumerate(ROUNDS):
        jkw = [jnp.asarray(kw[k], jnp.float32) for k in ("mask", "weights", "update_scale")]
        tkw = [torch.tensor(kw[k]) for k in ("mask", "weights", "update_scale")]
        jargs = (jstate, s["jbatches"][r], jkw[0], None, jkw[1], None, jkw[2])
        targs = (state, s["batches"][r], tkw[0], None, tkw[1], None, tkw[2])
        jprev, prev = jstate, state
        if jalgo.stateful:
            jstate, jm, jvar = jfn(*jargs, jvar, jnp.asarray(SCAFFOLD_IDS, jnp.int32))
            state, m, var = fn(*targs, var, torch.tensor(SCAFFOLD_IDS))
        else:
            jstate, jm = jfn(*jargs)
            state, m = fn(*targs)
        assert set(m) == set(jm) and all(v.ndim == 0 for v in m.values())
        assert int(state.round) == int(jstate.round) == r + 1
        yield (prev, state, m, var), (jprev, jstate, jm, jvar)


def test_round_fn_matches_reference(round_setup, round_pair):
    """Two rounds of each local algorithm against the reference: metrics and
    the new lora_c / lora_s within 1e-4 of the largest value (per leaf);
    scaffold also its variates, gathered and scattered by algo_ids."""
    name, jalgo, jfn, fn = round_pair
    gaps = []
    for r, ((_, state, m, var), (_, jstate, jm, jvar)) in enumerate(
            _rounds(round_setup, jalgo, jfn, fn)):
        if jalgo.stateful:
            for side in (0, 1):
                gaps.append(_close_lora(var[side], jvar[side], ROUND, f"{name} variates r{r}"))
        for k in jm:
            gaps.append(_close(m[k], jm[k], ROUND, f"{name} r{r} {k}"))
        gaps.append(_close_lora(state.lora_c, jstate.lora_c, ROUND, f"{name} r{r} lora_c"))
        gaps.append(_close_lora(state.lora_s, jstate.lora_s, ROUND, f"{name} r{r} lora_s"))
    print(f"{name}: largest gap {max(gaps):.2e} of the largest value")


def _flat(tree, reference=False):
    """All leaves of a port tree, or of a reference tree, as one fp32 vector,
    in the order JAX flattens the tree."""
    leaves = jax.tree.leaves(tree) if reference else \
        _leaves_by_reference_order(tree, tree_leaves(tree))
    return np.concatenate([_np(x).ravel() for x in leaves])


def _same_dtypes(got, want):
    """Every leaf of the port's tree has the reference's dtype."""
    names = lambda leaves: [str(x.dtype).removeprefix("torch.") for x in leaves]  # noqa: E731
    assert names(_leaves_by_reference_order(got, tree_leaves(got))) == \
        names(jax.tree.leaves(want))


def _surrogate_grads(cast):
    """A split gradient that both libraries compute bit for bit: every
    adapter leaf times a per-client scalar s (plus a constant c on B), read
    from the client's tokens and rounded to the leaf's dtype by ``cast``.
    The round's own arithmetic is then all that can differ."""
    def value_and_grad(base, lc, ls, batch, cfg, cut, **_):
        t = batch["tokens"]
        s, c = (t[0, 0] % 7 + 1) / 8, (t[0, 1] % 5 + 1) / 1024  # fp32, exact
        grad = lambda tree: {k: {"A": ab["A"] * cast(s, ab["A"]),  # noqa: E731
                                 "B": ab["B"] * cast(s, ab["B"]) + cast(c, ab["B"])}
                             for k, ab in tree.items()}
        return s, grad(lc), grad(ls), {}
    return value_and_grad


@pytest.mark.parametrize("name,kw", ALGOS, ids=[a for a, _ in ALGOS])
def test_round_algebra_bf16_matches_reference_bitwise(round_setup_bf16, monkeypatch, name, kw):
    """The round's own arithmetic in bfloat16 (h starts as bf16 zeros, ∇G
    and the step stay in the gradient's dtype, Python scalars round to bf16
    as JAX's weak types do, aggregation in fp32 cast back, the update in
    fp32 cast back, scaffold's variates) against the reference, with the
    split gradient replaced on both sides by one they compute bit for bit.
    Two rounds: new adapters bit-identical and of the reference's dtypes;
    the losses equal; scaffold's variates bit-identical (the reference's fp32
    weighted sums compile into fused multiply-adds, which the port's fedavg
    reproduces); h_c_norm, an fp32 sum of squares over the stacked h_k that
    the two libraries add in different orders, within 1e-5 (1.7e-6 measured
    with h_k bit-identical)."""
    s = round_setup_bf16
    monkeypatch.setattr(jax_split, "split_value_and_grad",
                        _surrogate_grads(lambda x, like: x.astype(like.dtype)))
    monkeypatch.setattr(split, "split_value_and_grad",
                        _surrogate_grads(lambda x, like: x.to(like.dtype)))
    jalgo, jfn, fn = _round_fns(s, name, kw, exact=True)
    for r, ((_, state, m, var), (_, jstate, jm, jvar)) in enumerate(_rounds(s, jalgo, jfn, fn)):
        for side in ("lora_c", "lora_s"):
            _same_dtypes(getattr(state, side), getattr(jstate, side))
            _close_lora(getattr(state, side), getattr(jstate, side), 0.0, f"{name} r{r} {side}")
        _same_dtypes(m, jm)
        for k in ("loss_round_start", "loss_local_final"):
            _close(m[k], jm[k], 0.0, f"{name} r{r} {k}")
        _close(m["h_c_norm"], jm["h_c_norm"], 1e-5, f"{name} r{r} h_c_norm")
        if jalgo.stateful:
            _same_dtypes(var, jvar)
            for side in (0, 1):
                _close_lora(var[side], jvar[side], 0.0, f"{name} r{r} variates")


def test_round_fn_bf16_matches_reference(round_setup_bf16):
    """One gd round in bfloat16, model included, then a second with a mask,
    weights and update_scale, against the reference from the same bridged
    state and batches. The two libraries round bfloat16 activations and
    gradients in different places, so the limits are set from the gaps
    measured when written (in brackets): the losses within 1e-4 of their
    value (1.1e-5), h_c_norm within 1e-2 (2.0e-3), the aggregated update
    h̄ = Δw' − Δw of each side within 0.1 relative Frobenius (0.036); and
    the same dtypes. A round whose update is scaled by 0.5 on one side,
    drops a client from the average or loses ξ·ḡ sits at 0.5 or more."""
    s = round_setup_bf16
    jalgo, jfn, fn = _round_fns(s, "gd", {})
    for r, ((prev, state, m, _), (jprev, jstate, jm, _)) in enumerate(_rounds(s, jalgo, jfn, fn)):
        _same_dtypes(m, jm)
        for k in ("loss_round_start", "loss_local_final"):
            _close(m[k], jm[k], 1e-4, f"r{r} {k}")
        _close(m["h_c_norm"], jm["h_c_norm"], 1e-2, f"r{r} h_c_norm")
        for side in ("lora_c", "lora_s"):
            _same_dtypes(getattr(state, side), getattr(jstate, side))
            hbar = _flat(getattr(state, side)) - _flat(getattr(prev, side))
            jhbar = (_flat(getattr(jstate, side), reference=True)
                     - _flat(getattr(jprev, side), reference=True))
            gap = np.linalg.norm(hbar - jhbar) / np.linalg.norm(jhbar)
            assert gap <= 0.1, f"r{r} h̄ {side}: {gap:.3e}"


def test_masked_client_batch_has_no_effect(round_setup):
    """A client masked out of the round changes nothing, whatever its batch."""
    s = round_setup
    fn = fedsllm.build_round_fn(s["cfg"], FedsLLMConfig(num_clients=K_ROUND), 1, ETA)
    mask = torch.tensor([1.0, 0.0, 1.0])
    a, _ = fn(s["state"], s["batches"][0], mask=mask)
    other = {k: v.clone() for k, v in s["batches"][0].items()}
    other["tokens"][1] = s["batches"][1]["tokens"][0]
    other["labels"][1] = s["batches"][1]["labels"][0]
    b, _ = fn(s["state"], other, mask=mask)
    for x, y in zip(tree_leaves((a.lora_c, a.lora_s)), tree_leaves((b.lora_c, b.lora_s))):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_init_state_matches_reference_shapes(round_setup):
    s = round_setup
    own = fedsllm.init_state(s["cfg"], cut=1, seed=0, device="cpu")
    shapes = lambda tree: {k: {n: tuple(v.shape) for n, v in ab.items()} for k, ab in tree.items()}
    assert shapes(own.lora_c) == shapes(jax.device_get(s["jstate"].lora_c))
    assert shapes(own.lora_s) == shapes(jax.device_get(s["jstate"].lora_s))
    assert not any(v["B"].any() for v in own.lora_c.values())
    assert own.round.dtype == torch.int32 and int(own.round) == 0


@pytest.mark.parametrize("what", ["compressor", "dp_clip"])
def test_later_slices_raise_not_implemented(round_setup, what):
    kw = {"compressor": {"compressor": object()}, "dp_clip": {"dp_clip": 1.0}}[what]
    with pytest.raises(NotImplementedError, match="later slice"):
        fedsllm.build_round_fn(round_setup["cfg"], FedsLLMConfig(), 1, ETA, **kw)


@pytest.mark.parametrize("eta", [0.9, 0.5, 0.1])
def test_lemma_counts_match_reference(eta):
    assert fedsllm.local_iteration_count(FedsLLMConfig(), eta) == \
        JF.local_iteration_count(JaxFedsLLMConfig(), eta)
    assert fedsllm.global_round_count(FedsLLMConfig(), eta) == \
        JF.global_round_count(JaxFedsLLMConfig(), eta)


# ---------------------------------------------------------------------------
# the delay model (numpy): bit-identical
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,seed,eta,A", [(4, 0, 0.5, 0.3), (50, 7, 0.9, 0.1), (13, 3, 0.2, 0.9)])
def test_delay_model_bit_identical(K, seed, eta, A):
    cfg, jcfg = FedsLLMConfig(num_clients=K), JaxFedsLLMConfig(num_clients=K)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    net, jnet = dm.sample_network(cfg, seed=seed), jax_dm.sample_network(jcfg, seed=seed)
    for f in dataclasses.fields(jnet):
        np.testing.assert_array_equal(getattr(net, f.name), getattr(jnet, f.name), err_msg=f.name)
    ls, jls = dm.sample_large_scale(cfg, seed), jax_dm.sample_large_scale(jcfg, seed)
    assert ls.digest == jls.digest
    rnet, jrnet = dm.realize_network(cfg, ls, seed + 1), jax_dm.realize_network(jcfg, jls, seed + 1)
    np.testing.assert_array_equal(rnet.g_s, jrnet.g_s)
    rng = np.random.default_rng(seed)
    t_c, t_s = rng.uniform(0.01, 1.0, K), rng.uniform(0.01, 1.0, K)
    assert dm.local_iters(cfg, eta) == jax_dm.local_iters(jcfg, eta)
    assert dm.lemma_a(cfg) == jax_dm.lemma_a(jcfg)
    for fn in ("compute_time",):
        np.testing.assert_array_equal(getattr(dm, fn)(cfg, net, eta, A),
                                      getattr(jax_dm, fn)(jcfg, jnet, eta, A))
    for fn in ("round_latency", "energy"):
        np.testing.assert_array_equal(getattr(dm, fn)(cfg, net, eta, A, t_c, t_s, 1000),
                                      getattr(jax_dm, fn)(jcfg, jnet, eta, A, t_c, t_s, 1000))
    r = rng.uniform(1e3, 1e6, K)
    np.testing.assert_array_equal(dm.bandwidth_for_rate(r, net.g_c, net.p_c_max, net.N0),
                                  jax_dm.bandwidth_for_rate(r, jnet.g_c, jnet.p_c_max, jnet.N0))


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------


def test_token_stream_recipe():
    V = 97
    stream = TokenStream(4, 64, V, seed=3, device="cpu")
    b = stream.batch_at(5)
    assert b["tokens"].shape == b["labels"].shape == b["mask"].shape == (4, 64)
    assert b["tokens"].dtype == torch.int64 and b["mask"].dtype == torch.float32
    torch.testing.assert_close(b["labels"], torch.roll(b["tokens"], -1, dims=1))
    again = TokenStream(4, 64, V, seed=3, device="cpu").batch_at(5)
    assert torch.equal(again["tokens"], b["tokens"])
    assert not torch.equal(stream.batch_at(6)["tokens"], b["tokens"])
    assert not torch.equal(TokenStream(4, 64, V, seed=4, device="cpu").batch_at(5)["tokens"],
                           b["tokens"])
    # the bigram share: structure + (1 - structure)/V of the transitions
    perm = torch.randperm(V, generator=torch.Generator().manual_seed(PERM_SEED))
    toks = torch.cat([stream.batch_at(s)["tokens"] for s in range(20)])
    share = (toks[:, 1:] == perm[toks[:, :-1]]).float().mean().item()
    assert abs(share - (0.8 + 0.2 / V)) < 0.02, share
    stacked = client_batches(stream, 2, 3)
    assert stacked["tokens"].shape == (3, 4, 64)
    assert torch.equal(stacked["tokens"][1], stream.batch_at(7)["tokens"])


def test_token_stream_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TokenStream(2, 8, 16).batch_at(0)


# ---------------------------------------------------------------------------
# the kernels are forward-only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["lora_matmul", "flash_attention", "ssd_scan"])
def test_kernel_wrappers_raise_under_grad(kernel):
    """Each wrapper raises, on the CPU as on the card, where an input requires
    grad and grad mode is on; under no_grad, or with no such input, it runs."""
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g)
    calls = {
        "lora_matmul": (lambda t: lora_matmul(t[0], t[1], t[2], t[3], scale=2.0),
                        [r(4, 8), r(8, 6), r(8, 2), r(2, 6)]),
        "flash_attention": (lambda t: flash_attention(*t), [r(1, 2, 5, 4), r(1, 1, 5, 4),
                                                             r(1, 1, 5, 4)]),
        "ssd_scan": (lambda t: ssd_scan(*t), [r(1, 6, 2, 4), r(1, 6, 2).abs(), -r(2).abs(),
                                              r(1, 6, 3), r(1, 6, 3)]),
    }
    fn, inputs = calls[kernel]
    fn(inputs)  # nothing requires grad
    for i in range(len(inputs)):
        args = [t.clone().requires_grad_(j == i) for j, t in enumerate(inputs)]
        with pytest.raises(RuntimeError, match="forward-only"):
            fn(args)
        with torch.no_grad():
            fn(args)
