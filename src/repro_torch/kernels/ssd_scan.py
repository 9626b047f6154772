"""Binding of the SSD chunked-scan CUDA kernels (``csrc/ssd_scan.cu``), the
port of ``repro/kernels/ssd_scan.py``'s Pallas kernel, and the rule that
picks one of its three variants:

* ``wgmma``: bf16 x/B/C (the main path): TMA loads + warpgroup MMA with
  two-term bf16 splits, one block per (batch, head, 32 columns of P), any P
  (the last slice masked), N up to 256 (padded to a multiple of 64 by TMA's
  zero fill) and any strides: the C entry reads each of x, B, C by TMA where
  a tensor map can (``copied`` asks it which) and copies the others'
  tiles;
* ``tf32``: fp32 x/B/C, N up to 256, any P and strides: every product in
  3xTF32 on warpgroup MMA (``ssd_ref.ssd_scan_tf32x3_ref`` mirrors its
  arithmetic);
* ``fma``: N above 256 (bf16 or fp32), whose state does not fit a
  warpgroup's registers at 32 columns of P: the first port's kernel, fp32
  FMAs, where the state fits a block's shared memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_SMEM = 227 * 1024  # a block's shared memory on the H100
FMA_CHUNK = 32  # the fma variant's steps per chunk (the SSD does not depend on it)
CHUNK, P_SLICE = 64, 32  # the wgmma and tf32 variants' steps per chunk and columns of P a block
MAX_N = 256  # the widest state the wgmma and tf32 variants hold


def smem_bytes(kind: str, P: int, N: int, copied: bool = False) -> int:
    """Shared memory of one block of variant ``kind`` (csrc/ssd_scan.cu
    ``tc::Layout``, ``tf32::Layout``, ``simt::smem_floats``); ``copied``:
    the wgmma variant's instance with copied tiles (their staging)."""
    if kind == "fma":
        NP = N | 1
        L = FMA_CHUNK
        return 4 * (P * NP + L * P + 2 * L * NP + L * L + L)
    if kind == "tf32":
        raw = 2 * CHUNK * 64 * 4 + CHUNK * P_SLICE * 4  # C, B and x as loaded
        terms = 2 * (2 * CHUNK * 32 * 4) + 2 * 2 * (2 * P_SLICE * 32 * 4)  # B_k; h_k or x, w⊙x
        return 1024 + raw + terms + CHUNK * 2 * 4
    nb = -(-N // 64)
    x_tile = CHUNK * P_SLICE * 2
    tiles = x_tile + 2 * nb * CHUNK * 64 * 2  # x, B, C of one chunk
    h_terms = 2 * nb * P_SLICE * 64 * 2
    staging = (CHUNK * 16 * 5 + 2 * nb * CHUNK * 16 * 9) if copied else 0
    return 1024 + tiles + h_terms + 2 * x_tile + CHUNK * 2 * 4 + staging + 8


def variant(dtype: torch.dtype, N: int) -> str:
    """The variant for x/Bm/Cm of ``dtype`` and state width ``N``: every
    stride and alignment (``copied`` says what the wgmma variant copies)."""
    if N > MAX_N:
        return "fma"
    return "wgmma" if dtype == torch.bfloat16 else "tf32"


def copied(strides, pointers) -> str:
    """The operands of x, Bm, Cm whose tiles the wgmma variant copies, asked
    of its C entry's own rule (``ssd_scan_copied``: a tensor map needs a
    16-byte aligned pointer and strides that are positive multiples of 8
    elements). ``strides``: x's (batch, seq, head), then Bm's and Cm's
    (batch, seq); ``pointers``: their data pointers. Needs the built
    library, as a launch does."""
    lib, _ = _entries()
    mask = lib.ssd_scan_copied(*(ctypes.c_void_p(p) for p in pointers),
                               (ctypes.c_longlong * 10)(*strides[:3], 0, 0, 0, *strides[3:]))
    return "".join(name for i, name in enumerate("xBC") if mask >> i & 1)


@functools.cache
def _entries():
    lib = _build.load("ssd_scan")
    fns = {}
    for name in ("wgmma", "tf32", "fma"):
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
