"""Binding of the flash attention CUDA kernels (``csrc/flash_attention.cu``),
the port of ``repro/kernels/flash_attention.py``'s Pallas kernel, and the
rule that picks one of its three variants:

* ``wgmma``: TMA + warpgroup MMA with the softmax in registers, bf16, head
  dims 64 (fedsllm-100m), 128 (phi4-mini, starcoder2, command-r) and 256
  (gemma2-9b) with 16-byte aligned rows: every bf16 serve;
* ``wmma``: the first port's kernel, bf16, head dims 16 and 32, and every
  head dim with strides or pointers that TMA cannot read;
* ``fp32``: fp32 inputs, every head dim and any strides: 3xTF32 on wgmma
  (each operand a TF32 big and small term, three products), P kept in fp32;
  ``attn_ref.flash_attention_tf32x3_ref`` mirrors its arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernels' compiled head widths
WGMMA_HEAD_DIMS = (64, 128, 256)


def variant(d: int, strides, pointers, fp32: bool = False) -> str:
    """The variant for head dim ``d``, the (batch, head, seq) element strides
    of q, k and v, and their data pointers: TMA needs every stride a
    positive multiple of 8 elements (16 bytes) and 16-byte aligned pointers.
    ``fp32``: the inputs are fp32, which only the ``fp32`` variant takes."""
    if fp32:
        return "fp32"
    aligned = (all(s > 0 and s % 8 == 0 for s in strides)
               and all(p % 16 == 0 for p in pointers))
    return "wgmma" if d in WGMMA_HEAD_DIMS and aligned else "wmma"


@functools.cache
def _entries():
    lib = _build.load("flash_attention")
    fns = {}
    for name in ("wgmma", "wmma", "fp32"):
        fn = getattr(lib, "flash_attention_fp32" if name == "fp32"
                     else f"flash_attention_{name}_bf16")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return lib, fns


def flash_attention_cuda(q, k, v, causal: bool, window: int, softcap: float, kind: str):
    """q (B,H,Sq,d), k/v (B,Kv,Skv,d): bf16 (fp32 for the ``fp32`` variant)
    views on one CUDA device whose last dim is contiguous; ``kind`` is the
    variant (see ``variant``). Returns (B,H,Sq,d) laid out in memory as
    (B,Sq,H,d), the model's layout, so the caller's transpose back is free."""
    lib, fns = _entries()
    B, H, Sq, d = q.shape
    Kv, Skv = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    _build.launch(lib, fns[kind], f"flash_attention ({kind})", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Kv, Sq, Skv, d, strides,
                  int(causal), int(window), float(softcap), 1.0 / math.sqrt(d))
    return o
