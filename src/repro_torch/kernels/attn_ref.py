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
