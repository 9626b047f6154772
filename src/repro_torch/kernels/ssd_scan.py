"""Binding of the SSD chunked-scan CUDA kernel (``csrc/ssd_scan.cu``), the
port of ``repro/kernels/ssd_scan.py``'s Pallas kernel."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_SMEM = 227 * 1024  # a block's shared memory on the H100
CHUNK = 32  # the kernel's steps per chunk (the SSD does not depend on it)


def smem_bytes(P: int, N: int) -> int:
    """Shared memory of one block (csrc/ssd_scan.cu ``smem_floats``)."""
    NP = N | 1
    return 4 * (P * NP + CHUNK * P + 2 * CHUNK * NP + CHUNK * CHUNK + CHUNK)


@functools.cache
def _entry():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def ssd_scan_cuda(x, dt, A, Bm, Cm, initial_state):
    """x (B,S,H,P), Bm/Cm (B,S,N): bf16 or fp32 views on one CUDA device with
    their last dim contiguous; dt (B,S,H) and A (H,) fp32 (A contiguous);
    initial_state (B,H,P,N) fp32 contiguous or None. Returns (y (B,S,H,P),
    final state (B,H,P,N)), both fp32 and contiguous."""
    lib, fn = _entry()
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 10)(*x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                                       *Cm.stride()[:2])
    h0 = initial_state.data_ptr() if initial_state is not None else None
    _build.launch(lib, fn, "ssd_scan", x.device, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                  Bm.data_ptr(), Cm.data_ptr(), h0, y.data_ptr(), h_final.data_ptr(), B, S, H, P,
                  N, strides, int(x.dtype == torch.bfloat16))
    return y, h_final
