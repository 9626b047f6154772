"""Plain PyTorch version of flash attention (after
``repro/kernels/attn_ref.py``)."""

from __future__ import annotations

import math

import torch


def flash_attention_fp32(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, q_chunk: int = 0):
    """q: (B,H,Sq,d); k/v: (B,Kv,Skv,d) -> fp32 (B,H,Sq,d). ``q_chunk`` > 0
    computes the scores that many queries at a time (a 32k prefill's scores
    are tens of GB at once)."""
    B, H, Sq, d = q.shape
    Kv, Skv = k.shape[1], k.shape[2]
    rep = H // Kv
    kk = torch.repeat_interleave(k, rep, dim=1).float()
    vv = torch.repeat_interleave(v, rep, dim=1).float()
    kpos = torch.arange(Skv, device=q.device)[None, :]
    step = q_chunk or max(Sq, 1)
    out = []
    for i in range(0, Sq, step):
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i:i + step].float(), kk) / math.sqrt(d)
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        qpos = torch.arange(i, min(i + step, Sq), device=q.device)[:, None]
        mask = torch.ones((qpos.shape[0], Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        out.append(torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vv))
        del s
    return out[0] if len(out) == 1 else torch.cat(out, dim=2)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """q: (B,H,Sq,d); k/v: (B,Kv,Skv,d) -> (B,H,Sq,d), probabilities in fp32."""
    return flash_attention_fp32(q, k, v, causal=causal, window=window,
                                softcap=softcap).to(q.dtype)


TF32_TERMS = ("q", "k", "p", "v")  # the small terms of the fp32 variant's products


def tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
    on its fp32 bits, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    """x = big + small (up to small's own rounding): big = tf32(x), small =
    tf32(x - big)."""
    big = tf32(x)
    return big, tf32(x.float() - big)


def flash_attention_tf32x3_ref(q, k, v, *, causal: bool = True, window: int = 0,
                               softcap: float = 0.0, terms=TF32_TERMS, tile: int = 64):
    """The arithmetic of the CUDA kernel's ``fp32`` variant, in plain
    PyTorch: q, k, v (fp32, (B,H,Sq,d), (B,Kv,Skv,d)) split into TF32 big and
    small terms; per key tile of ``tile`` keys S = qs·kbᵀ + qb·ksᵀ + qb·kbᵀ,
    the online softmax (running max, denominator, O rescaled by corr), P
    split the same way and the tile's P·V = ps·vb + pb·vs + pb·vb summed from
    zero and added into O in fp32. ``terms`` names the small terms kept
    (``TF32_TERMS``; leaving one out shows what it carries). Key tiles the
    kernel skips (all masked) change nothing here: their weights are 0 and
    their corr 1."""
    B, H, Sq, d = q.shape
    Kv, Skv = k.shape[1], k.shape[2]
    rep = H // Kv
    qb, qs = split_tf32(q)
    kb, ks = (torch.repeat_interleave(t, rep, dim=1) for t in split_tf32(k))
    vb, vs = (torch.repeat_interleave(t, rep, dim=1) for t in split_tf32(v))
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(d)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, H, Sq, 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, Sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, Skv, tile):
        sl = slice(k0, min(k0 + tile, Skv))
        s = ((qs @ kb[:, :, sl].transpose(-1, -2) if "q" in terms else zero)
             + (qb @ ks[:, :, sl].transpose(-1, -2) if "k" in terms else zero)
             + qb @ kb[:, :, sl].transpose(-1, -2)) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        kpos = torch.arange(k0, sl.stop, device=q.device)[None, :]
        mask = torch.ones((Sq, sl.stop - k0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, torch.full_like(s, -math.inf))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pb, ps = split_tf32(p)
        o = o * corr + ((ps @ vb[:, :, sl] if "p" in terms else zero)
                        + (pb @ vs[:, :, sl] if "v" in terms else zero)
                        + pb @ vb[:, :, sl])
        m = m_new
    return o / torch.clamp(l, min=1e-30)

