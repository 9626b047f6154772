"""Public wrapper of flash attention (after ``repro/kernels/attn_ops.py``).

A tensor on the CPU goes to the plain version (on the meta device too: shapes
only, no launch, nothing counted); a CUDA tensor launches one of the CUDA
kernel's variants (``wgmma`` for bf16, ``fp32``; any head dim from 1 to 256,
any strides; picked by ``variant`` of ``flash_attention.py``) or raises.
Unlike the reference wrapper, nothing is padded and ragged lengths never
fall back: the kernel masks the edge itself. ``flash_attention.launches``
counts kernel launches, ``flash_attention.variant_launches`` counts them by
variant.
Forward-only: with grad mode on, an input that requires grad raises
(``kernels.require_no_grad``), on every device."""

from __future__ import annotations

import torch

from repro_torch.kernels import require_no_grad
from repro_torch.kernels.attn_ref import flash_attention_ref
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM, flash_attention_cuda, variant


def _check(q, k, v):
    if not (q.ndim == k.ndim == v.ndim == 4) or k.shape != v.shape:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    B, H, Sq, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    if 0 in (B, H, Sq, k.shape[2], d):
        raise ValueError(f"flash_attention: empty input q{tuple(q.shape)} k{tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: mixed dtypes {q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: tensors on different devices")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    if q.device.type == "cuda":
        if q.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"flash_attention: the CUDA kernel takes bfloat16 or float32, "
                            f"got {q.dtype}")
        if d > MAX_HEAD_DIM:
            raise ValueError(f"flash_attention: the CUDA kernel takes head dims 1 to "
                             f"{MAX_HEAD_DIM}, got {d}")
    elif q.device.type not in ("cpu", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """q (B,H,Sq,d), k/v (B,Kv,Skv,d) -> (B,H,Sq,d). Any strides with a
    contiguous last dim; query position i sees key positions j <= i (causal)
    and j > i - window (window > 0), both counted from 0."""
    _check(q, k, v)
    require_no_grad("flash_attention", q, k, v)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    kind = variant(q.shape[-1], q.dtype == torch.float32)
    o = flash_attention_cuda(q, k, v, causal, window, softcap, kind)
    flash_attention.launches += 1
    flash_attention.variant_launches[kind] += 1
    return o


flash_attention.launches = 0
flash_attention.variant_launches = {"wgmma": 0, "fp32": 0}

__all__ = ["flash_attention", "flash_attention_ref"]
