"""Optimizers over trees of tensors (port of ``repro/optim/optimizers.py``).

Each optimizer is a pair of functions (init, update) over trees. Moments
are kept in ``moment_dtype`` (fp32 by default) while params may be bf16:
the update math runs in fp32 and casts back (mixed-precision training).
``update`` returns new trees and leaves its inputs as they are, as the
reference's pure functions do.

The arithmetic follows the reference's expression by expression: Python
numbers next to an fp32 tensor are rounded to fp32 first (JAX's weakly
typed scalars), ``b1 ** t`` is an fp32 power of the fp32 step, and no
``float / tensor`` appears (torch computes it as ``reciprocal() * float``,
two roundings).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], tuple[Any, Any]]
    # update(grads, state, params, step) -> (new_params, new_state)


def _lr_fn(lr):
    return lr if callable(lr) else (lambda step: lr)


def _leafwise(fn, *trees):
    """fn over the leaves of the first tree (a nested dict, as parameter
    trees are), each paired with the matching subtree of the others: a leaf,
    or a deeper tree, as adafactor's state is."""
    if isinstance(trees[0], dict):
        return {k: _leafwise(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _split(out, n: int):
    """A tree whose leaves are n-tuples, as n trees."""
    return tuple(_leafwise(lambda t: t[i], out) for i in range(n))


def sgd(lr: Callable | float, momentum: float = 0.9, nesterov: bool = False,
        weight_decay: float = 0.0, moment_dtype="float32") -> Optimizer:
    lr_fn = _lr_fn(lr)
    mdtype = torch_dtype(moment_dtype)

    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdtype, device=p.device),
                              params)}

    def update(grads, state, params, step):
        lr_t = lr_fn(step)

        def one(g, p, m=None):
            g32 = g.float()
            if weight_decay:
                g32 = g32 + weight_decay * p.float()
            if m is None:
                return (p.float() - lr_t * g32).to(p.dtype), None
            m_new = momentum * m.float() + g32
            step_dir = g32 + momentum * m_new if nesterov else m_new
            return (p.float() - lr_t * step_dir).to(p.dtype), m_new.to(mdtype)

        if momentum == 0.0:
            return _leafwise(lambda g, p: one(g, p)[0], grads, params), state
        new_params, new_m = _split(_leafwise(one, grads, params, state["m"]), 2)
        return new_params, {"m": new_m}

    return Optimizer(init, update)


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01, moment_dtype="float32") -> Optimizer:
    lr_fn = _lr_fn(lr)
    mdtype = torch_dtype(moment_dtype)

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=mdtype, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        t = step.float() + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t

        def one(g, p, m, v):
            g32 = g.float()
            m_new = b1 * m.float() + (1 - b1) * g32
            v_new = b2 * v.float() + (1 - b2) * g32 * g32
            mh = m_new / c1
            vh = v_new / c2
            upd = mh / (torch.sqrt(vh) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return ((p.float() - lr_t * upd).to(p.dtype), m_new.to(mdtype), v_new.to(mdtype))

        new_params, new_m, new_v = _split(
            _leafwise(one, grads, params, state["m"], state["v"]), 3)
        return new_params, {"m": new_m, "v": new_v}

    return Optimizer(init, update)


def adafactor(lr: Callable | float, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0) -> Optimizer:
    """Factored second moments for >=2D params (memory: O(m+n) not O(mn)).

    The state is a deeper tree than the params: ``{"f": ...}`` maps each
    param leaf to ``{"r", "c"}`` (row and column means, >= 2D) or ``{"v"}``,
    as the reference's."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def z(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return {"r": torch.zeros(p.shape[:-1], **f32),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return {"f": tree_map(z, params)}

    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        t = step.float() + 1.0
        beta = 1.0 - t ** (-decay)

        def one(g, p, f):
            g32 = g.float()
            sq = g32 * g32 + eps
            if g.ndim >= 2:
                r = beta * f["r"] + (1 - beta) * torch.mean(sq, dim=-1)
                c = beta * f["c"] + (1 - beta) * torch.mean(sq, dim=-2)
                rc = r / torch.clamp(torch.mean(r, dim=-1, keepdim=True), min=eps)
                vhat = rc[..., None] * c[..., None, :]
                upd = g32 / torch.sqrt(vhat + eps)
                new_f = {"r": r, "c": c}
            else:
                v = beta * f["v"] + (1 - beta) * sq
                upd = g32 / torch.sqrt(v + eps)
                new_f = {"v": v}
            rms = torch.sqrt(torch.mean(upd * upd) + 1e-12)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (p.float() - lr_t * upd).to(p.dtype), new_f

        new_params, new_f = _split(_leafwise(one, grads, params, state["f"]), 2)
        return new_params, {"f": new_f}

    return Optimizer(init, update)


def get_optimizer(name: str, lr, cfg: TrainConfig | None = None) -> Optimizer:
    """``sgd`` and ``adafactor`` take their defaults whatever ``cfg`` says,
    as the reference's do."""
    if name == "adamw":
        kw = {}
        if cfg is not None:
            kw = dict(b1=cfg.beta1, b2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay,
                      moment_dtype=cfg.moment_dtype)
        return adamw(lr, **kw)
    if name == "sgd":
        return sgd(lr)
    if name == "adafactor":
        return adafactor(lr)
    raise ValueError(name)
