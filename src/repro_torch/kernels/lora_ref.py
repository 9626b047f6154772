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


def lora_matmul_split_ref(x, w, a, b, *, scale: float = 1.0):
    """The prefill and decode kernels' arithmetic above 64 ranks, in plain PyTorch:
    scale·u is folded as two bf16 terms h = bf16(scale·u) and l =
    bf16(scale·u − h), y = x·W + h·B + l·B summed in fp32 and cast once.
    h + l keeps 16 significant bits of scale·u (a relative error below
    2^-16), far inside the bf16 output's rounding: it stays within the
    tolerances of ``lora_matmul_ref``."""
    xf = x.float()
    v = scale * (xf @ a.float())
    h = v.bfloat16().float()
    lo = (v - h).bfloat16().float()
    bf = b.float()
    return (xf @ w.float() + h @ bf + lo @ bf).to(x.dtype)
