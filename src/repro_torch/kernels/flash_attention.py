"""Binding of the flash attention CUDA kernels (``csrc/flash_attention.cu``),
the port of ``repro/kernels/flash_attention.py``'s Pallas kernel, and the
rule that picks one of its two variants, both at every head dim from 1 to
256 (compiled at ``HEAD_DIMS``; a head dim between them runs at the next,
``padded_dim``, its columns past d zeros):

* ``wgmma``: TMA + warpgroup MMA with the softmax in registers, bf16, any
  strides: every bf16 serve (head dims 64 for fedsllm-100m, 128 for
  phi4-mini, starcoder2 and command-r, 256 for gemma2-9b). The C entry
  reads each of q, k, v by TMA where a tensor map can (``copied`` asks it
  which) and has the producer warps copy the tiles of the others;
* ``fp32``: fp32 inputs, any strides: 3xTF32 on wgmma (each operand a TF32
  big and small term, three products), P kept in fp32;
  ``attn_ref.flash_attention_tf32x3_ref`` mirrors its arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernels' compiled head widths
MAX_HEAD_DIM = HEAD_DIMS[-1]  # above it O no longer fits a warpgroup's registers


def padded_dim(d: int) -> int:
    """The compiled width that head dim ``d`` (1 to 256) runs at: the
    smallest of ``HEAD_DIMS`` that holds it."""
    return next(w for w in HEAD_DIMS if w >= d)


def variant(d: int, fp32: bool = False) -> str:
    """The variant for head dim ``d`` (1 to 256): ``fp32`` for fp32 inputs,
    else ``wgmma``, at every stride and alignment (``copied`` says which
    operands it copies)."""
    return "fp32" if fp32 else "wgmma"


def copied(strides, pointers) -> str:
    """The operands of q, k, v (in that order) whose tiles the ``wgmma``
    variant copies, asked of its C entry's own rule (``flash_attention_copied``:
    a tensor map needs a 16-byte aligned pointer and (batch, head, seq)
    strides that are positive multiples of 8 elements). ``strides``: the 9
    element strides of q, k and v; ``pointers``: their data pointers. Needs
    the built library, as a launch does."""
    lib, _ = _entries()
    mask = lib.flash_attention_copied(*(ctypes.c_void_p(p) for p in pointers),
                                      (ctypes.c_longlong * 9)(*strides))
    return "".join(name for i, name in enumerate("qkv") if mask >> i & 1)


@functools.cache
def _entries():
    lib = _build.load("flash_attention")
    fns = {}
    for name, symbol in (("wgmma", "flash_attention_wgmma_bf16"),
                         ("fp32", "flash_attention_fp32")):
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return lib, fns


def flash_attention_cuda(q, k, v, causal: bool, window: int, softcap: float, kind: str):
    """q (B,H,Sq,d), k/v (B,Kv,Skv,d): bf16 (fp32 for the ``fp32`` variant)
    views on one CUDA device whose last dim is contiguous; ``kind`` is the
    variant (see ``variant``). Returns (B,H,Sq,d) laid out in memory as
    (B,Sq,H,d), the model's layout, so the caller's transpose back is free;
    at a head dim between the compiled widths, as the first d columns of
    (B,Sq,H,``padded_dim(d)``), whose rows the kernel writes whole."""
    lib, fns = _entries()
    B, H, Sq, d = q.shape
    Kv, Skv = k.shape[1], k.shape[2]
    dp = padded_dim(d)  # the instance the C entry runs, and o's allocated width
    o = torch.empty((B, Sq, H, dp), dtype=q.dtype, device=q.device).transpose(1, 2)[..., :d]
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    _build.launch(lib, fns[kind], f"flash_attention ({kind})", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Kv, Sq, Skv, d, dp, strides,
                  int(causal), int(window), float(softcap), 1.0 / math.sqrt(d))
    return o
