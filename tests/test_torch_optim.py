"""The port's optimizers, schedules and gradient utilities (``repro_torch.optim``)
against the reference's, run live on the same numpy inputs.

Tolerances:
  * fp32 params and moments: within 1e-6 of each leaf's largest magnitude
    after 1 and 3 updates (the same fp32 expressions; the two libraries'
    ``pow``, ``sqrt`` and means may round their last bit differently);
  * bf16 params: equal, except elements whose fp32 update lands within
    rounding distance of a bf16 boundary, which may round to the
    neighbouring value: at most one bf16 step apart, and at most 1% of the
    elements (the test prints how many);
  * schedules: within 1e-7 relative (fp32 arithmetic on one scalar);
  * clipping: within 1e-6 of each leaf's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JaxTrainConfig
from repro.optim import grad_utils as jax_grad_utils
from repro.optim import optimizers as jax_optimizers
from repro.optim import schedules as jax_schedules
from repro_torch import bridge
from repro_torch.config import TrainConfig
from repro_torch.optim import grad_utils, optimizers, schedules
from repro_torch.tree import tree_leaves

SHAPES = {"w": (16, 12), "b": (12,), "block": {"k": (3, 8, 10), "scale": (10,)}}
LR = dict(lr=1e-2, warmup_steps=2, total_steps=10)


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _cast(tree, dtype):
    return jax.tree.map(lambda x: x.astype(dtype), tree)


def _flat(tree, path=()):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat(tree[k], path + (k,)).items()}
    return {path: tree}


def _pairs(port_tree, ref_tree):
    """(port tensor, port leaf as fp32 numpy, reference leaf as fp32 numpy),
    matched by path, shapes checked."""
    got, want = _flat(port_tree), _flat(jax.device_get(ref_tree))
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    out = []
    for k in sorted(want):
        g, w = got[k].detach().float().numpy(), np.asarray(want[k], np.float32)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        out.append((got[k], g, w))
    return out


def _bf16_steps(got, want):
    """Elements of got that differ from want, and the largest difference in
    bf16 steps (units in the last place of want)."""
    diff = got != want
    if not diff.any():
        return 0, 0.0
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want[diff]))) - 7)
    return int(diff.sum()), float(np.max(np.abs(got[diff] - want[diff]) / ulp))


def _optimizer_pair(name):
    jlr = jax_schedules.cosine_with_warmup(LR["lr"], LR["warmup_steps"], LR["total_steps"])
    tlr = schedules.cosine_with_warmup(LR["lr"], LR["warmup_steps"], LR["total_steps"])
    return (jax_optimizers.get_optimizer(name, jlr, JaxTrainConfig()),
            optimizers.get_optimizer(name, tlr, TrainConfig()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_optimizer_matches_reference(name, steps, dtype):
    rng = np.random.default_rng(0)
    jdtype = jnp.dtype(dtype)
    jparams = _cast(_tree(rng, SHAPES), jdtype)
    grads = [_cast(_tree(rng, SHAPES, 0.1), jdtype) for _ in range(steps)]
    jopt, topt = _optimizer_pair(name)
    jstate = jopt.init(jparams)
    params = bridge.params_from_numpy(jax.device_get(jparams), device="cpu")
    state = bridge.opt_state_from_numpy(jax.device_get(jstate), device="cpu")
    # the port's init gives the reference's tree, zeros and dtypes
    tinit = topt.init(params)
    assert jax.tree.structure(jax.device_get(jstate)) == jax.tree.structure(
        bridge.opt_state_to_numpy(tinit))
    for t, g in enumerate(grads):
        jparams, jstate = jopt.update(g, jstate, jparams, jnp.asarray(t, jnp.int32))
        params, state = topt.update(bridge.params_from_numpy(jax.device_get(g), device="cpu"),
                                    state, params, torch.tensor(t, dtype=torch.int32))
    # the state keeps the reference's tree: adafactor's is deeper than the params
    assert jax.tree.structure(jax.device_get(jstate)) == jax.tree.structure(
        bridge.opt_state_to_numpy(state))
    for _, got, want in _pairs(state, jstate):
        assert np.max(np.abs(got - want)) <= 1e-6 * max(np.max(np.abs(want)), 1e-30)
    differ = 0
    for p, got, want in _pairs(params, jparams):
        assert str(p.dtype).split(".")[-1] == dtype
        if dtype == "float32":
            assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))
        else:
            n, steps_apart = _bf16_steps(got, want)
            assert steps_apart <= 1.0, steps_apart
            differ += n
    total = sum(x.size for x in jax.tree.leaves(jparams))
    print(f"{name} x{steps} {dtype}: {differ} of {total} params differ by one bf16 step")
    assert differ <= 0.01 * total


def test_optimizer_update_leaves_its_inputs():
    rng = np.random.default_rng(1)
    _, topt = _optimizer_pair("adamw")
    params = bridge.params_from_numpy(_tree(rng, SHAPES), device="cpu")
    before = [p.clone() for p in tree_leaves(params)]
    state = topt.init(params)
    topt.update(bridge.params_from_numpy(_tree(rng, SHAPES), device="cpu"), state, params,
                torch.tensor(0, dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
    assert all(not t.any() for t in tree_leaves(state))


def test_get_optimizer_names():
    with pytest.raises(ValueError):
        optimizers.get_optimizer("lion", 1e-3)
    # sgd takes its defaults whatever the config says, as the reference's does
    params = {"w": torch.zeros(3)}
    assert set(optimizers.get_optimizer("sgd", 1e-3, TrainConfig()).init(params)) == {"m"}


@pytest.mark.parametrize("kind", ["constant", "linear_warmup", "cosine_with_warmup"])
def test_schedules_match_reference(kind):
    lr, warmup, total = 3e-4, 7, 30
    args = {"constant": (lr,), "linear_warmup": (lr, warmup),
            "cosine_with_warmup": (lr, warmup, total)}[kind]
    jfn, tfn = getattr(jax_schedules, kind)(*args), getattr(schedules, kind)(*args)
    for step in (0, warmup - 1, warmup, total):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = tfn(arg)
            assert got.dtype == torch.float32 and got.shape == ()
            assert abs(got.item() - want) <= 1e-7 * abs(want), (step, got.item(), want)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])  # clips, and leaves as is
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_reference(max_norm, dtype):
    rng = np.random.default_rng(3)
    jtree = _cast(_tree(rng, SHAPES, 0.3), jnp.dtype(dtype))
    tree = bridge.params_from_numpy(jax.device_get(jtree), device="cpu")
    jclipped, jgn = jax_grad_utils.clip_by_global_norm(jtree, max_norm)
    clipped, gn = grad_utils.clip_by_global_norm(tree, max_norm)
    assert abs(gn.item() - float(jgn)) <= 1e-6 * float(jgn)
    assert abs(grad_utils.global_norm(tree).item() - float(jax_grad_utils.global_norm(jtree))) \
        <= 1e-6 * float(jgn)
    for c, got, want in _pairs(clipped, jclipped):
        assert str(c.dtype).split(".")[-1] == dtype
        assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))


def test_accumulate_matches_reference():
    rng = np.random.default_rng(4)
    jtrees = [_tree(rng, SHAPES) for _ in range(3)]
    want = jax_grad_utils.accumulate([jax.tree.map(jnp.asarray, t) for t in jtrees])
    got = grad_utils.accumulate([bridge.params_from_numpy(t, device="cpu") for t in jtrees])
    for _, g, w in _pairs(got, want):
        assert np.max(np.abs(g - w)) <= 1e-6 * np.max(np.abs(w))
