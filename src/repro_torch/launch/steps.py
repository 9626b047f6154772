"""Step builders: train / prefill / serve steps for a given config (port of
``repro/launch/steps.py``), the optimizer state on the meta device, and the
spec trees of a batch and a cache over a mesh.

``abstract_opt_state`` is ``opt.init`` on meta parameters (the reference's
``jax.eval_shape``). ``batch_shardings`` and ``cache_shardings`` give the
reference's specs (``parallel/sharding.py``'s ``spec_for``) as trees of
plain tuples over a given mesh; on the one-card mesh each places the whole
tensor on the card. ``param_shardings`` and ``opt_state_shardings`` are not
ported: the port's parameters carry no logical axes, and one card shards
nothing. The train step runs the plain training path (``T.loss_fn``, no
kernel: the kernels are forward-only), with autograd in place of
``jax.value_and_grad``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.optim.grad_utils import clip_by_global_norm
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.parallel.sharding import Rules, spec_for
from repro_torch.tree import tree_leaves, tree_like, tree_map

# logical axes of the batch's named leaves (any other leaf: unsharded)
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"), "mask": ("batch", "seq"),
              "vision_embeds": ("batch", "seq", None), "frame_embeds": ("batch", None, "embed")}


def batch_shardings(batch_specs, mesh, rules: Rules, kind: str) -> dict:
    """The spec of each named batch leaf over ``mesh`` (``kind`` is taken
    and unused, as in the reference)."""
    return {k: spec_for(v.shape, BATCH_AXES.get(k, (None,) * v.ndim), rules, mesh)
            for k, v in batch_specs.items()}


def cache_shardings(cache_tree, mesh, rules: Rules):
    """The spec of each cache leaf over ``mesh``, from ``T.cache_axes``."""
    return tree_map(lambda v: spec_for(v.shape, T.cache_leaf_axes(v), rules, mesh), cache_tree)


def abstract_opt_state(opt, params_meta):
    """The optimizer state of ``params_meta`` (meta tensors): ``opt.init``
    on the meta device, shapes and dtypes only."""
    return opt.init(tree_map(lambda p: p.to("meta"), params_meta))


def _value_and_grad(loss_fn, params, batch):
    """((loss, metrics), grads) of ``loss_fn(params, batch)`` w.r.t. every
    leaf of ``params``; the grads have the params' dtypes."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_like(params, leaves), batch)
        # a leaf the loss never reads gets a zero gradient, as jax.grad gives
        # (whisper's cross-attention biases: ROADMAP §3)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    metrics = tree_map(lambda t: t.detach(), metrics)
    return (loss.detach(), metrics), tree_like(params, list(grads))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, unroll: bool = False):
    """(train_step, optimizer). ``train_step(params, opt_state, step, batch)
    -> (params, opt_state, step + 1, metrics)``: cosine schedule, the named
    optimizer, global-norm clipping and, with ``tcfg.microbatch`` = M > 1,
    gradient accumulation over M slices of the batch in fp32 accumulators,
    averaged (the reference's ``lax.scan``, a Python loop here; the metrics
    are the last slice's). ``unroll`` is taken and ignored (``T.loss_fn``)."""
    lr = cosine_with_warmup(tcfg.learning_rate, tcfg.warmup_steps, tcfg.total_steps)
    opt = get_optimizer(tcfg.optimizer, lr, tcfg)
    remat = tcfg.remat != "none"
    loss_fn = functools.partial(T.loss_fn, cfg=cfg, remat=remat, unroll=unroll)

    def grads_of(params, batch):
        if tcfg.microbatch and tcfg.microbatch > 1:
            M = tcfg.microbatch
            B = tree_leaves(batch)[0].shape[0]
            assert B % M == 0, (B, M)
            mb = B // M
            loss_a = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            g_a = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                           params)
            for i in range(M):
                sub = tree_map(lambda x: x[i * mb:(i + 1) * mb], batch)
                (loss, metrics), g = _value_and_grad(loss_fn, params, sub)
                g_a = tree_map(lambda a, b: a + b.float(), g_a, g)
                loss_a = loss_a + loss
            inv = 1.0 / M
            return (loss_a * inv, metrics), tree_map(lambda x: x * inv, g_a)
        return _value_and_grad(loss_fn, params, batch)

    def train_step(params, opt_state, step, batch):
        (loss, metrics), grads = grads_of(params, batch)
        grads, gn = clip_by_global_norm(grads, tcfg.grad_clip)
        params, opt_state = opt.update(grads, opt_state, params, step)
        out_metrics = {"loss": loss, "grad_norm": gn, **metrics}
        return params, opt_state, step + 1, out_metrics

    return train_step, opt


def make_prefill_step(cfg: ModelConfig, *, unroll: bool = False):
    """``prefill_step(params, batch, cache) -> (logits, cache)`` (the cache is
    written in place); ``unroll`` is taken and ignored."""
    def prefill_step(params, batch, cache):
        return T.prefill(params, batch, cfg, cache)

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, unroll: bool = False):
    """``serve_step(params, tokens, cache, pos) -> (next tokens (B, 1), cache)``,
    greedy. The next tokens are int64 (the port's token type; the reference
    casts to int32). An encoder-decoder step cross-attends to ``enc_out``
    when given, else to the ``cross`` cache that the prefill filled."""
    def serve_step(params, tokens, cache, pos, enc_out=None):
        logits, new_cache = T.decode_step(params, tokens, cache, pos, cfg, enc_out=enc_out)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        return nxt, new_cache

    return serve_step
