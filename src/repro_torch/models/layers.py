"""Transformer layers of the dense decoder (port of ``repro/models/layers.py``).

Parameters are plain dicts of tensors with the reference's names and its
``(d_in, d_out)`` weight layout, so ``y = x @ W`` and the fused LoRA kernel
reads W as (K, N) as the TPU kernel does. Sharding annotations of the
reference are dropped: one card holds everything.

A targeted projection goes through ``project``: plain ``x @ W`` without an
adapter, the fused LoRA kernel with one. Prefill attention goes through the
flash kernel (``kernels=True``) or the reference's plain attentions
(``_attend_plain``: dense, banded for a sliding window, or query-chunked).
Training, as in the reference, passes no adapter (it merges them into W,
``lora.merge``) and ``kernels=False``: the kernels are forward-only, and
their wrappers raise on an input that requires grad.

Sliding-window layers keep a ring-buffer KV cache of ``window`` slots, slot
``p % window`` holding position p. The reference's prefill keeps the last
``window`` keys in slots 0..window-1, which is that layout only when the
prompt length is a multiple of the window (or shorter than it); the port
writes the ring layout for every prompt length, so that its decode agrees
with the reference's ``forward`` over the longer sequence.
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
from repro_torch.tree import weak

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
    p = {"scale": make_param(gen, (dim,), cfg.param_dtype, init="ones", device=device)}
    if cfg.norm_type == "layernorm" and cfg.use_bias:
        p["bias"] = make_param(gen, (dim,), cfg.param_dtype, init="zeros", device=device)
    return p


def apply_norm(p, x, cfg: ModelConfig, eps: float = 1e-6):
    """RMSNorm, or LayerNorm (population variance), in fp32, cast back to x.dtype."""
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def rms_norm_only(w, x, eps: float = 1e-6):
    """RMSNorm over the last dim with scale ``w`` in fp32, cast back to x.dtype
    (the q/k norm of ``qk_norm`` configs)."""
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
            * w.float()).to(x.dtype)


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
    p = {
        "wq": make_param(gen, (D, H * hd), dt, device=device),
        "wk": make_param(gen, (D, Kv * hd), dt, device=device),
        "wv": make_param(gen, (D, Kv * hd), dt, device=device),
        "wo": make_param(gen, (H * hd, D), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers),
                         device=device),
    }
    if cfg.use_bias:
        for name, n in (("bq", H * hd), ("bk", Kv * hd), ("bv", Kv * hd), ("bo", D)):
            p[name] = make_param(gen, (n,), dt, init="zeros", device=device)
    if cfg.qk_norm:
        p["q_norm"] = make_param(gen, (hd,), dt, init="ones", device=device)
        p["k_norm"] = make_param(gen, (hd,), dt, init="ones", device=device)
    return p


def _softcap(logits, cap: float):
    if cap and cap > 0:
        if _no_grad(logits):  # in place: no copy of a (B, S, V) or (.., S, S) tensor
            return logits.div_(cap).tanh_().mul_(cap)
        return cap * torch.tanh(logits / cap)
    return logits


def _no_grad(t) -> bool:
    """No gradient flows through ``t``: the plain paths may then work in
    place (the same operations in the same order, without the copies)."""
    return not (torch.is_grad_enabled() and t.requires_grad)


def _scores(logits, hd: int, softcap: float, mask):
    """Attention scores logits/sqrt(hd), softcapped, -1e30 where ``mask`` is
    False; in place where no gradient flows (the logits of a long prefill
    are GBs)."""
    if _no_grad(logits):
        return _softcap(logits.div_(math.sqrt(hd)), softcap).masked_fill_(~mask, -1e30)
    logits = _softcap(logits / math.sqrt(hd), softcap)
    return torch.where(mask, logits, torch.full_like(logits, -1e30))


def _attend_full(q, k, v, *, causal: bool, window: int, softcap: float, q_offset: int = 0):
    """Dense masked attention, the plain baseline. q: (B,Sq,H,hd); k/v: (B,Skv,Kv,hd);
    query i sits at absolute position q_offset + i, key j at j."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    qh = q.reshape(B, Sq, Kv, H // Kv, hd)
    logits = torch.einsum("bqkrh,bskh->bkrqs", qh.float(), k.float())
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window and window > 0:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    probs = torch.softmax(_scores(logits, hd, softcap, mask), dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, v)
    return out.reshape(B, Sq, H * hd)


def _attend_banded(q, k, v, *, window: int, softcap: float):
    """Causal sliding-window attention in blocks of ``window`` queries, each
    attending to its own block and the one before: O(S·2w·hd) instead of
    O(S²·hd). Exact for S % window == 0."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    assert S % window == 0, (S, window)
    nb = S // window
    qb = q.reshape(B, nb, window, Kv, H // Kv, hd)
    kb = k.reshape(B, nb, window, Kv, hd)
    vb = v.reshape(B, nb, window, Kv, hd)
    # the previous block (block -1 is zeros, masked out)
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1), kb], dim=2)
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1), vb], dim=2)
    logits = torch.einsum("bnqkrh,bnskh->bnkrqs", qb.float(), k2.float())
    qpos = torch.arange(window, device=q.device)[:, None]  # within the block
    kpos = torch.arange(2 * window, device=q.device)[None, :] - window  # from the block's start
    mask = (kpos <= qpos) & (kpos > qpos - window)
    first = torch.arange(nb, device=q.device) == 0  # block 0 has no previous block
    mask = mask[None] & ~(first[:, None, None] & (kpos[None] < 0))  # (nb, w, 2w)
    probs = torch.softmax(_scores(logits, hd, softcap, mask[None, :, None, None]),
                          dim=-1).to(q.dtype)
    out = torch.einsum("bnkrqs,bnskh->bnqkrh", probs, v2)
    return out.reshape(B, S, H * hd)


def _attend_chunked_q(q, k, v, *, causal: bool, window: int, softcap: float, chunk: int):
    """``_attend_full`` a chunk of queries at a time against the whole of k/v:
    the logits held at once are (chunk, Skv) per head (long prefills)."""
    return torch.cat([_attend_full(q[:, i:i + chunk], k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=i)
                      for i in range(0, q.shape[1], chunk)], dim=1)


def _attend_plain(q, k, v, *, causal: bool, window: int, softcap: float, q_chunk: int = 0):
    """The reference's choice among its plain attentions for a full sequence:
    banded for a causal window that divides S, query chunks for S > q_chunk,
    else dense."""
    S = q.shape[1]
    if causal and window and window > 0 and S % window == 0 and S > window:
        return _attend_banded(q, k, v, window=window, softcap=softcap)
    if q_chunk and S > q_chunk:
        return _attend_chunked_q(q, k, v, causal=causal, window=window, softcap=softcap,
                                 chunk=q_chunk)
    return _attend_full(q, k, v, causal=causal, window=window, softcap=softcap)


def _attend_flash(q, k, v, *, causal: bool, window: int, softcap: float):
    """The flash kernel on the model's layout: (B,S,H,hd) views, no copies."""
    B, S, H, hd = q.shape
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window, softcap=softcap)
    return o.transpose(1, 2).reshape(B, S, H * hd)


def _ring_positions(cache_pos: int, window: int, device=None):
    """Absolute position held by each slot of a ring buffer of ``window``
    slots once position ``cache_pos`` is written: slot j holds the largest
    p <= cache_pos with p % window == j (negative: not written yet)."""
    slots = torch.arange(window, device=device)
    cur = cache_pos % window
    base = cache_pos - cur
    return torch.where(slots <= cur, base + slots, base - window + slots)


def _decode_attend(q, ck, cv, *, cfg: ModelConfig, window: int, cache_pos: int,
                   kpos_abs=None):
    """q: (B,1,H,hd) against a cache (B,Sc,Kv,hd). ``kpos_abs``: the absolute
    position of each slot of a ring buffer; None for a cache whose slot j
    holds position j."""
    B, Sq, H, hd = q.shape
    Kv = ck.shape[2]
    qh = q.reshape(B, Sq, Kv, H // Kv, hd)
    logits = torch.einsum("bqkrh,bskh->bkrqs", qh.float(), ck.to(q.dtype).float())
    if kpos_abs is not None:
        valid = (kpos_abs >= 0) & (kpos_abs <= cache_pos)
    else:
        kpos_abs = torch.arange(ck.shape[1], device=q.device)
        valid = kpos_abs <= cache_pos
    if window and window > 0:
        valid &= kpos_abs > cache_pos - window
    probs = torch.softmax(_scores(logits, hd, cfg.attn_logit_softcap, valid),
                          dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, cv.to(q.dtype))
    return out.reshape(B, Sq, H * hd)


def _write_prefill(cache, k, v):
    """Write a prompt's keys and values into a cache of S_c slots, in place:
    slot p % S_c holds position p, for the last S_c positions (all of them
    when S <= S_c)."""
    ck, cv = cache
    S, S_c = k.shape[1], ck.shape[1]
    if S <= S_c:
        ck[:, :S], cv[:, :S] = k, v
    else:
        slots = torch.arange(S - S_c, S, device=k.device) % S_c
        ck[:, slots] = k[:, S - S_c:].to(ck.dtype)
        cv[:, slots] = v[:, S - S_c:].to(cv.dtype)


def attention(p, x, cfg: ModelConfig, *, positions, window: int = 0, adapters=None,
              cache: Optional[tuple] = None, cache_pos: Optional[int] = None,
              kernels: bool = True, q_chunk: int = 0, causal: bool = True):
    """GQA attention, global (``window=0``) or over the last ``window``
    positions; positions (B, S). ``causal=False`` (an encoder's, which has
    no cache) lets every query see every key.

    cache: (k, v), each (B, S_cache, Kv, hd), updated in place: a
    single-token x decodes at absolute position ``cache_pos`` (into slot
    ``cache_pos % window`` of a ring buffer, S_cache == window); a longer x is
    a prefill that attends to its own keys and writes the cache
    (``_write_prefill``). A full sequence runs the flash kernel
    (``kernels``) or the reference's plain choice (``_attend_plain``).
    """
    B, S, _ = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ad = adapters or {}
    q = project(x, p["wq"], ad.get("wq"))
    k = project(x, p["wk"], ad.get("wk"))
    v = project(x, p["wv"], ad.get("wv"))
    if "bq" in p:
        q, k, v = (t + p[b].to(t.dtype) for t, b in ((q, "bq"), (k, "bk"), (v, "bv")))
    q, k, v = q.reshape(B, S, H, hd), k.reshape(B, S, Kv, hd), v.reshape(B, S, Kv, hd)
    if cfg.qk_norm:  # before RoPE and the cache write, on prefill and decode alike
        q, k = rms_norm_only(p["q_norm"], q), rms_norm_only(p["k_norm"], k)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    softcap = cfg.attn_logit_softcap
    if cache is not None and S == 1:
        ck, cv = cache
        ring = window and window > 0 and ck.shape[1] == window
        slot = cache_pos % window if ring else cache_pos
        ck[:, slot], cv[:, slot] = k[:, 0], v[:, 0]
        out = _decode_attend(q, ck, cv, cfg=cfg, window=window, cache_pos=cache_pos,
                             kpos_abs=_ring_positions(cache_pos, window, q.device) if ring
                             else None)
    else:
        if cache is not None:
            _write_prefill(cache, k, v)
        if kernels:
            out = _attend_flash(q, k, v, causal=causal, window=window, softcap=softcap)
        else:
            out = _attend_plain(q, k, v, causal=causal, window=window, softcap=softcap,
                                q_chunk=q_chunk)
    y = project(out, p["wo"], ad.get("wo"))
    if "bo" in p:
        y = y + p["bo"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# MLP (SwiGLU, GeGLU or GELU; the GELUs in their tanh approximation)
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, device=None):
    act, D, F_, dt = cfg.mlp_activation, cfg.d_model, cfg.d_ff, cfg.param_dtype
    if act not in ("swiglu", "geglu", "gelu"):
        raise ValueError(f"mlp_activation={act!r}: swiglu, geglu or gelu")
    p = {}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = make_param(gen, (D, F_), dt, device=device)
    p["w_up"] = make_param(gen, (D, F_), dt, device=device)
    if act == "gelu" and cfg.use_bias:
        p["b_up"] = make_param(gen, (F_,), dt, init="zeros", device=device)
    p["w_down"] = make_param(gen, (F_, D), dt, scale=0.02 / math.sqrt(2 * cfg.num_layers),
                             device=device)
    if cfg.use_bias:
        p["b_down"] = make_param(gen, (D,), dt, init="zeros", device=device)
    return p


def apply_mlp(p, x, cfg: ModelConfig, *, adapters=None):
    ad = adapters or {}
    up = project(x, p["w_up"], ad.get("w_up"))
    if cfg.mlp_activation == "swiglu":
        h = F.silu(project(x, p["w_gate"], ad.get("w_gate"))) * up
    elif cfg.mlp_activation == "geglu":
        h = F.gelu(project(x, p["w_gate"], ad.get("w_gate")), approximate="tanh") * up
    else:
        if "b_up" in p:
            up = up + p["b_up"].to(up.dtype)
        h = F.gelu(up, approximate="tanh")
    y = project(h, p["w_down"], ad.get("w_down"))
    if "b_down" in p:
        y = y + p["b_down"].to(y.dtype)
    return y


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
        # rounded to the working dtype first, as the reference does
        # (sqrt(3584) is 59.75 in bf16): a bf16 product then rounds once
        x = x * weak(cfg.embedding_multiplier, x)
    return x


def lm_logits(p, x, cfg: ModelConfig):
    """(B,S,D) -> fp32 (B,S,V): products of the working type accumulated in fp32."""
    w = p["tokens"].T if cfg.tie_embeddings else p["head"]
    logits = x.float() @ w.to(x.dtype).float()
    if cfg.logit_scale != 1.0:
        logits = logits.mul_(cfg.logit_scale) if _no_grad(logits) else logits * cfg.logit_scale
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
