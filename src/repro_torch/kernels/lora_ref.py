"""Plain PyTorch version of the fused LoRA matmul (after
``repro/kernels/lora_ref.py``)."""

from __future__ import annotations

import torch


def lora_matmul_ref(x, w, a, b, *, scale: float = 1.0):
    """y = x·W + scale·(x·A)·B, fp32 accumulation, cast to x.dtype."""
    xf = x.float()
    base = xf @ w.float()
    u = xf @ a.float()
    delta = u @ b.float()
    return (base + scale * delta).to(x.dtype)
