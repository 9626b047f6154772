"""Plain PyTorch version of flash attention (after
``repro/kernels/attn_ref.py``)."""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """q: (B,H,Sq,d); k/v: (B,Kv,Skv,d) -> (B,H,Sq,d), probabilities in fp32."""
    B, H, Sq, d = q.shape
    Kv, Skv = k.shape[1], k.shape[2]
    rep = H // Kv
    kk = torch.repeat_interleave(k, rep, dim=1).float()
    vv = torch.repeat_interleave(v, rep, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / math.sqrt(d)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
