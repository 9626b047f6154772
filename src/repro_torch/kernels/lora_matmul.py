"""Binding of the fused LoRA matmul CUDA kernel (``csrc/lora_matmul.cu``),
the port of ``repro/kernels/lora_matmul.py``'s Pallas kernel."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_RANK = 64  # the kernel holds u = x·A in at most four 16-wide fragments


@functools.cache
def _entry():
    lib = _build.load("lora_matmul")
    fn = lib.lora_matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def lora_matmul_cuda(x, w, a, b, scale: float):
    """x (M,K), w (K,N), a (K,r), b (r,N): contiguous bf16 on one CUDA device."""
    lib, fn = _entry()
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
                 M, K, N, r, float(scale), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "lora_matmul")
    return y
