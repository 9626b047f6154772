"""Public wrapper of the fused LoRA matmul (after ``repro/kernels/lora_ops.py``).

Flattens leading dims and checks its inputs. A tensor on the CPU goes to the
plain version (on the meta device too: shapes only, no launch, nothing
counted); a CUDA tensor launches one of the CUDA kernel's variants
(bf16 or fp32, any rank; picked from the dtype and shapes by ``plan`` of
``lora_matmul.py``) or raises.
``lora_matmul.launches`` counts kernel launches, and
``lora_matmul.variant_launches`` counts them by variant.
Forward-only: with grad mode on, an input that requires grad raises
(``kernels.require_no_grad``), on every device."""

from __future__ import annotations

import torch

from repro_torch.kernels import require_no_grad
from repro_torch.kernels.lora_matmul import lora_matmul_cuda, plan
from repro_torch.kernels.lora_ref import lora_matmul_ref


def _check(x, w, a, b):
    if not (w.ndim == a.ndim == b.ndim == 2 and x.ndim >= 1):
        raise ValueError(f"lora_matmul: bad ranks x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"a{tuple(a.shape)} b{tuple(b.shape)}")
    K, N, r = w.shape[0], w.shape[1], a.shape[1]
    if x.shape[-1] != K or a.shape[0] != K or b.shape != (r, N) or 0 in (K, N, r):
        raise ValueError(f"lora_matmul: shapes do not chain: x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"a{tuple(a.shape)} b{tuple(b.shape)}")
    if not (x.dtype == w.dtype == a.dtype == b.dtype):
        raise TypeError(f"lora_matmul: mixed dtypes {x.dtype} {w.dtype} {a.dtype} {b.dtype}")
    if not (x.device == w.device == a.device == b.device):
        raise ValueError("lora_matmul: tensors on different devices")
    if not all(t.is_contiguous() for t in (x, w, a, b)):
        raise ValueError("lora_matmul: inputs must be contiguous")
    if x.device.type == "cuda":
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"lora_matmul: the CUDA kernel takes bfloat16 or float32, "
                            f"got {x.dtype}")
    elif x.device.type not in ("cpu", "meta"):
        raise ValueError(f"lora_matmul: unsupported device {x.device}")


def lora_matmul(x, w, a, b, *, scale: float = 1.0):
    """y = x·W + scale·(x·A)·B with x (..., K), w (K, N), a (K, r), b (r, N)."""
    _check(x, w, a, b)
    require_no_grad("lora_matmul", x, w, a, b)
    lead, K, N = x.shape[:-1], x.shape[-1], w.shape[1]
    x2 = x.reshape(-1, K)
    if x.device.type in ("cpu", "meta"):
        y = lora_matmul_ref(x2, w, a, b, scale=scale)
    else:
        aligned = not (x2.data_ptr() | w.data_ptr() | b.data_ptr()) % 16
        kind, extra = plan(x2.shape[0], K, N, a.shape[1], aligned, x.dtype == torch.float32)
        y = lora_matmul_cuda(x2, w, a, b, scale, kind, extra)
        lora_matmul.launches += 1
        lora_matmul.variant_launches[kind] += 1
    return y.reshape(*lead, N)


lora_matmul.launches = 0
lora_matmul.variant_launches = {"prefill": 0, "decode": 0, "fp32": 0}

__all__ = ["lora_matmul", "lora_matmul_ref"]
