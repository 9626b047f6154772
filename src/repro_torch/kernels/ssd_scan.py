"""Binding of the SSD chunked-scan CUDA kernels (``csrc/ssd_scan.cu``), the
port of ``repro/kernels/ssd_scan.py``'s Pallas kernel, and the rule that
picks one of its two variants:

* ``wgmma``: TMA loads + warpgroup MMA with two-term bf16 splits, one block
  per (batch, head, 32 columns of P) (the main path): bf16 x/B/C, P a
  multiple of 32, N in {64, 128, 192, 256}, 16-byte aligned strides and
  pointers;
* ``fma``: the first port's kernel, fp32 FMAs, bf16 or fp32, any P, N and strides
  whose state fits a block's shared memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_SMEM = 227 * 1024  # a block's shared memory on the H100
FMA_CHUNK = 32  # the fma variant's steps per chunk (the SSD does not depend on it)
WGMMA_CHUNK, WGMMA_P_SLICE = 64, 32
WGMMA_N = (64, 128, 192, 256)


def smem_bytes(kind: str, P: int, N: int) -> int:
    """Shared memory of one block of variant ``kind`` (csrc/ssd_scan.cu
    ``simt::smem_floats``, ``tc::Layout``)."""
    if kind == "fma":
        NP = N | 1
        L = FMA_CHUNK
        return 4 * (P * NP + L * P + 2 * L * NP + L * L + L)
    x_tile = WGMMA_CHUNK * WGMMA_P_SLICE * 2
    tiles = x_tile + 2 * (N // 64) * WGMMA_CHUNK * 64 * 2  # x, B, C of one chunk
    h_terms = 2 * (N // 64) * WGMMA_P_SLICE * 64 * 2
    return 1024 + tiles + h_terms + 2 * x_tile + WGMMA_CHUNK * 2 * 4 + 8


def variant(dtype: torch.dtype, P: int, N: int, strides, pointers) -> str:
    """The variant for x/Bm/Cm of ``dtype``, head width ``P``, state width
    ``N``, the element strides of x (batch, seq, head) and of Bm and Cm
    (batch, seq), and their data pointers: TMA needs every stride a positive
    multiple of 8 elements (16 bytes) and 16-byte aligned pointers."""
    aligned = (all(s > 0 and s % 8 == 0 for s in strides)
               and all(p % 16 == 0 for p in pointers))
    ok = dtype == torch.bfloat16 and P % WGMMA_P_SLICE == 0 and N in WGMMA_N and aligned
    return "wgmma" if ok else "fma"


@functools.cache
def _entries():
    lib = _build.load("ssd_scan")
    fns = {}
    for name in ("wgmma", "fma"):
        fn = getattr(lib, f"ssd_scan_{name}")
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return lib, fns


def ssd_scan_cuda(x, dt, A, Bm, Cm, initial_state, kind: str):
    """x (B,S,H,P), Bm/Cm (B,S,N): bf16 or fp32 views on one CUDA device with
    their last dim contiguous; dt (B,S,H) and A (H,) fp32 (A contiguous);
    initial_state (B,H,P,N) fp32 contiguous or None; ``kind`` is the variant
    (see ``variant``). Returns (y (B,S,H,P), final state (B,H,P,N)), both
    fp32 and contiguous."""
    lib, fns = _entries()
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 10)(*x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                                       *Cm.stride()[:2])
    h0 = initial_state.data_ptr() if initial_state is not None else None
    _build.launch(lib, fns[kind], f"ssd_scan ({kind})", x.device, x.data_ptr(), dt.data_ptr(),
                  A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), h0, y.data_ptr(),
                  h_final.data_ptr(), B, S, H, P, N, strides, int(x.dtype == torch.bfloat16))
    return y, h_final
