"""RecurrentGemma / Griffin recurrent block (port of ``repro/models/rglru.py``):
the RG-LRU behind a causal conv1d, gated by a GeGLU branch.

The diagonal linear recurrence h_t = a_t·h_{t-1} + b_t runs in fp32 as a
log-depth doubling scan (``_linear_scan``: ⌈log2 S⌉ steps of whole-sequence
elementwise products, where a loop over positions would launch S of them),
the reference's ``jax.lax.associative_scan`` in another combining order.
Decode is the one-step update. ``w_rec_in``, ``w_gate_in`` and ``w_out``
go through ``layers.project``, so an adapted one runs the fused LoRA kernel.

State cache, per layer: (conv_state (B, W-1, lru) in the working dtype,
h (B, lru) in fp32), both updated in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import _causal_conv

_C = 8.0  # RG-LRU decay sharpness constant (Griffin)


def init_rglru_block(gen, cfg: ModelConfig, device=None):
    """The reference's shapes and inits; the per-channel gates in fp32:
    w_a = b_a = b_x = 0, w_x = lambda_p = 1."""
    D, W, cw = cfg.d_model, cfg.lru_width, cfg.ssm_conv_width
    pd = cfg.param_dtype
    mk = lambda shape, dtype, **kw: L.make_param(gen, shape, dtype, device=device, **kw)
    return {
        "w_rec_in": mk((D, W), pd),
        "w_gate_in": mk((D, W), pd),
        "conv_w": mk((cw, W), pd, scale=1.0 / math.sqrt(cw)),
        "conv_b": mk((W,), pd, init="zeros"),
        "w_a": mk((W,), "float32", init="zeros"),
        "b_a": mk((W,), "float32", init="zeros"),
        "w_x": mk((W,), "float32", init="ones"),
        "b_x": mk((W,), "float32", init="zeros"),
        "lambda_p": mk((W,), "float32", init="ones"),
        "w_out": mk((W, D), pd, scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }


def _rglru_coeffs(p, x):
    """Per-step gates of x (B, S, W) (post-conv): (a, b), fp32."""
    xf = x.float()
    r = torch.sigmoid(xf * p["w_a"] + p["b_a"])  # recurrence gate
    i = torch.sigmoid(xf * p["w_x"] + p["b_x"])  # input gate
    log_a = -_C * F.softplus(p["lambda_p"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * xf)
    return a, b


def _linear_scan(a, b, h0=None):
    """h_t = a_t·h_{t-1} + b_t over axis 1 (h_{-1} = h0, or 0), fp32.
    Doubling: after the step of stride d, (a_t, b_t) composes positions
    t-2d+1..t, so ⌈log2 S⌉ steps leave b_t = h_t."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S, d = a.shape[1], 1
    while d < S:
        a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1))
        d *= 2
    return b


def apply_rglru_block(p, u, cfg: ModelConfig, cache=None, *, adapters=None):
    """u (B, S, D). cache: (conv_state, h), written in place, or None. A
    cache and S == 1 decode one step; anything else is a prefill, from the
    cache's state if there is one. Returns (B, S, D)."""
    ad = adapters or {}
    rec = L.project(u, p["w_rec_in"], ad.get("w_rec_in"))  # (B, S, W)
    gate = F.gelu(L.project(u, p["w_gate_in"], ad.get("w_gate_in")), approximate="tanh")
    rec, new_conv_state = _causal_conv(rec, p["conv_w"], p["conv_b"],
                                       cache[0] if cache is not None else None)
    a, b = _rglru_coeffs(p, rec)
    if cache is not None and u.shape[1] == 1:
        y = (a[:, 0] * cache[1] + b[:, 0])[:, None]
    else:
        y = _linear_scan(a, b, cache[1] if cache is not None else None)
    if cache is not None:
        cache[0].copy_(new_conv_state)
        cache[1].copy_(y[:, -1])
    return L.project(y.to(u.dtype) * gate, p["w_out"], ad.get("w_out"))


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device="cuda"):
    device = resolve_device(device)
    conv_state = torch.zeros((batch, cfg.ssm_conv_width - 1, cfg.lru_width), dtype=dtype,
                             device=device)
    h = torch.zeros((batch, cfg.lru_width), dtype=torch.float32, device=device)
    return conv_state, h
