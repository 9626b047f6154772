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


def _cluster_sum(x, w, split: int, step: int = 32, warps: int = 4):
    """x·w with the reduction's rows summed as the fp32 decode kernel's
    cluster sums them: cut into ``split`` slices of whole ``step``-row steps
    (one a block), each block's rows into the ``warps`` warps' equal shares
    of every step, the warps' partials added in order, then the blocks'."""
    K = x.shape[1]
    kc = -(-(-(-K // split)) // step) * step
    rows = torch.arange(K)
    total = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for c in range(split):
        block = None
        for wp in range(warps):
            share = (rows >= c * kc) & (rows < (c + 1) * kc) & \
                    ((rows - c * kc) % step // (step // warps) == wp)
            part = x[:, share] @ w[share]
            block = part if block is None else block + part
        total = total + block
    return total


def lora_matmul_fp32_split_ref(x, w, a, b, *, scale: float = 1.0, split: int = 1,
                               usplit: int = 1):
    """The fp32 decode design's order of sums, in plain PyTorch (fp32):
    ``_cluster_sum`` over ``split`` blocks. Up to 64 ranks u = x·A is summed
    the same way beside x·W and y = x·W + scale·u·B; above, a first launch
    sums scale·u over ``usplit`` blocks and the product runs over K + r rows,
    [x | scale·u]·[W; B]. The grouping is fixed, so the kernel gives the same
    bits on every call; the sums within a group differ from the kernel's only
    by fp32 rounding, within the 1e-5 of ``lora_matmul_ref``."""
    xf, wf, af, bf = (t.float() for t in (x, w, a, b))
    if a.shape[1] <= 64:
        return _cluster_sum(xf, wf, split) + scale * (_cluster_sum(xf, af, split) @ bf)
    su = scale * _cluster_sum(xf, af, usplit)
    return _cluster_sum(torch.cat([xf, su], 1), torch.cat([wf, bf], 0), split)
