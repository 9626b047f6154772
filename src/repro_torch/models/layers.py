"""Transformer layers of the dense decoder (port of ``repro/models/layers.py``).

Parameters are plain dicts of tensors with the reference's names and its
``(d_in, d_out)`` weight layout, so ``y = x @ W`` and the fused LoRA kernel
reads W as (K, N) as the TPU kernel does. Sharding annotations of the
reference are dropped: one card holds everything.

A targeted projection goes through ``project``: plain ``x @ W`` without an
adapter, the fused LoRA kernel with one. Prefill attention goes through the
flash kernel (``kernels=True``) or the plain ``_attend_full`` baseline.
Training, as in the reference, passes no adapter (it merges them into W,
``lora.merge``) and ``kernels=False``: the kernels are forward-only, and
their wrappers raise on an input that requires grad.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.kernels.attn_ops import flash_attention
from repro_torch.kernels.lora_ops import lora_matmul

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def make_param(gen: torch.Generator, shape, dtype: str, *, init: str = "normal",
               scale: float = 0.02, device=None) -> torch.Tensor:
    """One parameter, as ``repro.parallel.make_param`` draws it (normal × scale,
    ones or zeros, in fp32, then cast), from ``gen``."""
    if init == "normal":
        v = torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=device) * scale
    elif init == "ones":
        v = torch.ones(tuple(shape), dtype=torch.float32, device=device)
    elif init == "zeros":
        v = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    else:
        raise ValueError(init)
    return v.to(torch_dtype(dtype))


def project(x, w, adapter=None):
    """x @ W, or the fused LoRA kernel x·W + scale·(x·A)·B for an adapter (A, B, scale)."""
    w = w.to(x.dtype)
    if adapter is None:
        return x @ w
    a, b, scale = adapter
    return lora_matmul(x, w, a.to(x.dtype), b.to(x.dtype), scale=scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(gen, cfg: ModelConfig, dim: int, device=None):
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(f"norm_type={cfg.norm_type!r}: only rmsnorm is ported")
    return {"scale": make_param(gen, (dim,), cfg.param_dtype, init="ones", device=device)}


def apply_norm(p, x, cfg: ModelConfig, eps: float = 1e-6):
    """RMSNorm in fp32, cast back to x.dtype."""
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(f"norm_type={cfg.norm_type!r}: only rmsnorm is ported")
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-half, not interleaved)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def init_attn(gen, cfg: ModelConfig, device=None):
    D, H, Kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    return {
        "wq": make_param(gen, (D, H * hd), dt, device=device),
        "wk": make_param(gen, (D, Kv * hd), dt, device=device),
        "wv": make_param(gen, (D, Kv * hd), dt, device=device),
        "wo": make_param(gen, (H * hd, D), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers),
                         device=device),
    }


def _softcap(logits, cap: float):
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def _attend_full(q, k, v, *, causal: bool, window: int, softcap: float):
    """Dense masked attention, the plain baseline. q: (B,Sq,H,hd); k/v: (B,Skv,Kv,hd)."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    qh = q.reshape(B, Sq, Kv, H // Kv, hd)
    logits = torch.einsum("bqkrh,bskh->bkrqs", qh.float(), k.float()) / math.sqrt(hd)
    logits = _softcap(logits, softcap)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window and window > 0:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, v)
    return out.reshape(B, Sq, H * hd)


def _attend_flash(q, k, v, *, causal: bool, window: int, softcap: float):
    """The flash kernel on the model's layout: (B,S,H,hd) views, no copies."""
    B, S, H, hd = q.shape
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window, softcap=softcap)
    return o.transpose(1, 2).reshape(B, S, H * hd)


def _decode_attend(q, ck, cv, *, cfg: ModelConfig, cache_pos: int):
    """q: (B,1,H,hd) against a global cache (B,Sc,Kv,hd); keys at slots <= cache_pos."""
    B, Sq, H, hd = q.shape
    Kv = ck.shape[2]
    qh = q.reshape(B, Sq, Kv, H // Kv, hd)
    logits = torch.einsum("bqkrh,bskh->bkrqs", qh.float(),
                          ck.to(q.dtype).float()) / math.sqrt(hd)
    logits = _softcap(logits, cfg.attn_logit_softcap)
    valid = torch.arange(ck.shape[1], device=q.device) <= cache_pos
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, cv.to(q.dtype))
    return out.reshape(B, Sq, H * hd)


def attention(p, x, cfg: ModelConfig, *, positions, adapters=None,
              cache: Optional[tuple] = None, cache_pos: Optional[int] = None,
              kernels: bool = True):
    """Causal GQA attention with global (unwindowed) masking; positions (B, S).

    cache: (k, v), each (B, S_cache, Kv, hd), updated in place: a
    single-token x decodes at absolute position ``cache_pos``; a longer x is a
    prefill that attends to its own keys and writes slots [0, S).
    """
    B, S, _ = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ad = adapters or {}
    q = project(x, p["wq"], ad.get("wq")).reshape(B, S, H, hd)
    k = project(x, p["wk"], ad.get("wk")).reshape(B, S, Kv, hd)
    v = project(x, p["wv"], ad.get("wv")).reshape(B, S, Kv, hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and S == 1:
        ck, cv = cache
        ck[:, cache_pos], cv[:, cache_pos] = k[:, 0], v[:, 0]
        out = _decode_attend(q, ck, cv, cfg=cfg, cache_pos=cache_pos)
    else:
        if cache is not None:
            ck, cv = cache
            ck[:, :S], cv[:, :S] = k, v
        attend = _attend_flash if kernels else _attend_full
        out = attend(q, k, v, causal=True, window=0, softcap=cfg.attn_logit_softcap)
    return project(out, p["wo"], ad.get("wo"))


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, device=None):
    if cfg.mlp_activation != "swiglu":
        raise NotImplementedError(f"mlp_activation={cfg.mlp_activation!r}: only swiglu is ported")
    D, F_, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {
        "w_gate": make_param(gen, (D, F_), dt, device=device),
        "w_up": make_param(gen, (D, F_), dt, device=device),
        "w_down": make_param(gen, (F_, D), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers),
                             device=device),
    }


def apply_mlp(p, x, cfg: ModelConfig, *, adapters=None):
    if cfg.mlp_activation != "swiglu":
        raise NotImplementedError(f"mlp_activation={cfg.mlp_activation!r}: only swiglu is ported")
    ad = adapters or {}
    h = F.silu(project(x, p["w_gate"], ad.get("w_gate"))) * project(x, p["w_up"], ad.get("w_up"))
    return project(h, p["w_down"], ad.get("w_down"))


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def init_embed(gen, cfg: ModelConfig, device=None):
    p = {"tokens": make_param(gen, (cfg.vocab_size, cfg.d_model), cfg.param_dtype, device=device)}
    if not cfg.tie_embeddings:
        p["head"] = make_param(gen, (cfg.d_model, cfg.vocab_size), cfg.param_dtype, device=device)
    return p


def embed_tokens(p, tokens, cfg: ModelConfig):
    x = F.embedding(tokens, p["tokens"].to(torch_dtype(cfg.dtype)))
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return x


def lm_logits(p, x, cfg: ModelConfig):
    """(B,S,D) -> fp32 (B,S,V): products of the working type accumulated in fp32."""
    w = p["tokens"].T if cfg.tie_embeddings else p["head"]
    logits = x.float() @ w.to(x.dtype).float()
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return _softcap(logits, cfg.final_logit_softcap)


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in fp32. logits (B,S,V), labels (B,S)."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _chunk_nll_sum(xs, ls, ms, w, cfg: ModelConfig):
    """Masked sum of one sequence chunk's token NLLs; logits fp32 (the
    working type's products accumulated in fp32), then discarded."""
    logits = xs.float() @ w.float()
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    logits = _softcap(logits, cfg.final_logit_softcap)
    gold = logits.gather(-1, ls.long()[..., None])[..., 0]
    return torch.sum((torch.logsumexp(logits, dim=-1) - gold) * ms)


def fused_cross_entropy(params_embed, x, labels, cfg: ModelConfig, mask=None, chunk: int = 256):
    """Sequence-chunked CE, the reference's: each chunk's (B, chunk, V) fp32
    logits are reduced to a masked NLL sum and discarded, and recomputed in
    the backward (activation checkpointing, as the reference's
    ``jax.checkpoint``), so the full (B, S, V) logits never exist. A ragged
    S is padded to a chunk multiple with mask 0. Returns the masked mean."""
    B, S, _ = x.shape
    w = (params_embed["tokens"].T if cfg.tie_embeddings else params_embed["head"]).to(x.dtype)
    chunk = min(chunk, S)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    if S % chunk:
        pad = chunk - S % chunk
        x, labels, mask = F.pad(x, (0, 0, 0, pad)), F.pad(labels, (0, pad)), F.pad(mask, (0, pad))
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[1], chunk):
        ms = mask[:, i:i + chunk]
        nll_sum = nll_sum + checkpoint(_chunk_nll_sum, x[:, i:i + chunk], labels[:, i:i + chunk],
                                       ms, w, cfg, use_reentrant=False,
                                       preserve_rng_state=False)
        cnt = cnt + torch.sum(ms)
    return nll_sum / torch.clamp(cnt, min=1.0)
