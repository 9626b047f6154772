"""Binding of the flash attention CUDA kernel (``csrc/flash_attention.cu``),
the port of ``repro/kernels/flash_attention.py``'s Pallas kernel."""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's compiled head widths


@functools.cache
def _entry():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_bf16
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_cuda(q, k, v, causal: bool, window: int, softcap: float):
    """q (B,H,Sq,d), k/v (B,Kv,Skv,d): bf16 views on one CUDA device whose last
    dim is contiguous. Returns (B,H,Sq,d) laid out in memory as (B,Sq,H,d),
    the model's layout, so the caller's transpose back is free."""
    lib, fn = _entry()
    B, H, Sq, d = q.shape
    Kv, Skv = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Kv, Sq, Skv, d,
                 strides, int(causal), int(window), float(softcap), 1.0 / math.sqrt(d),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention")
    return o
