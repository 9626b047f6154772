"""Binding of the SSD chunked-scan CUDA kernels (``csrc/ssd_scan.cu``), the
port of ``repro/kernels/ssd_scan.py``'s Pallas kernel, and the rule that
picks one of its two variants, both at any P, any N and any strides:

* ``wgmma``: bf16 x/B/C (the main path): TMA loads + warpgroup MMA with
  two-term bf16 splits, one block per (batch, head, 32 columns of P, slice
  of N), the last P slice masked, a slice's N padded to a multiple of 64
  by TMA's zero fill; the C entry reads each of x, B, C by TMA where a
  tensor map can (``copied`` asks it which) and copies the others' tiles;
* ``tf32``: fp32 x/B/C: every product in 3xTF32 on warpgroup MMA
  (``ssd_ref.ssd_scan_tf32x3_ref`` mirrors its arithmetic).

A block holds at most 256 columns of N (its state lives in registers), so N
is split across blocks (``n_slices``, ``slice_width``): above 256 each
block writes its slice's partial y into fp32 scratch that the wrapper
allocates, and a second launch adds the partials in slice order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

CHUNK, P_SLICE = 64, 32  # the variants' steps per chunk and columns of P a block
SLICE_N = 256  # the widest slice of N a block holds


def n_slices(N: int) -> int:
    """The slices of N the kernel splits a state of width ``N`` into, one a
    block: ceil(N / 256)."""
    return -(-N // SLICE_N)


def slice_width(N: int) -> int:
    """The columns of N each slice takes: the slices are equally wide, a
    multiple of 64 (the kernel's column blocks), 64·ceil(N / (64·ns)); the
    last one's columns past N are zeros."""
    return 64 * -(-N // (64 * n_slices(N)))


def smem_bytes(kind: str, P: int, N: int, copied: bool = False) -> int:
    """Shared memory of one block of variant ``kind`` (csrc/ssd_scan.cu
    ``tc::Layout<NB, copied>``, NB = ``slice_width(N)`` / 64, or
    ``tf32::Layout``, which does not depend on N); ``copied``: the wgmma
    variant's instance with copied tiles (their staging)."""
    if kind == "tf32":
        raw = 2 * CHUNK * 64 * 4 + CHUNK * P_SLICE * 4  # C, B and x as loaded
        terms = 2 * (2 * CHUNK * 32 * 4) + 2 * 2 * (2 * P_SLICE * 32 * 4)  # B_k; h_k or x, w⊙x
        return 1024 + raw + terms + CHUNK * 2 * 4
    nb = slice_width(N) // 64
    x_tile = CHUNK * P_SLICE * 2
    tiles = x_tile + 2 * nb * CHUNK * 64 * 2  # x, B, C of one chunk
    h_terms = 2 * nb * P_SLICE * 64 * 2
    staging = (CHUNK * 16 * 5 + 2 * nb * CHUNK * 16 * 9) if copied else 0
    return 1024 + tiles + h_terms + 2 * x_tile + CHUNK * 2 * 4 + staging + 8


def variant(dtype: torch.dtype) -> str:
    """The variant for x/Bm/Cm of ``dtype``, at every P, N, stride and
    alignment (``copied`` says what the wgmma variant copies)."""
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
    for name in ("wgmma", "tf32"):
        fn = getattr(lib, f"ssd_scan_{name}")
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return lib, fns


def ssd_scan_cuda(x, dt, A, Bm, Cm, initial_state, kind: str):
    """x (B,S,H,P), Bm/Cm (B,S,N): bf16 or fp32 views on one CUDA device with
    their last dim contiguous; dt (B,S,H) and A (H,) fp32 (A contiguous);
    initial_state (B,H,P,N) fp32 contiguous or None; ``kind`` is the variant
    (see ``variant``). Returns (y (B,S,H,P), final state (B,H,P,N)), both
    fp32 and contiguous. The C entry runs the slices of N laid out here
    (``n_slices``, ``slice_width``), which also size the fp32 scratch
    (slices, B, S, H, P) that takes the partial ys above one slice."""
    lib, fns = _entries()
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    ns = n_slices(N)
    partial = (torch.empty((ns, B, S, H, P), dtype=torch.float32, device=x.device)
               if ns > 1 else None)
    strides = (ctypes.c_longlong * 10)(*x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
                                       *Cm.stride()[:2])
    h0 = initial_state.data_ptr() if initial_state is not None else None
    _build.launch(lib, fns[kind], f"ssd_scan ({kind})", x.device, x.data_ptr(), dt.data_ptr(),
                  A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), h0, y.data_ptr(),
                  h_final.data_ptr(), None if partial is None else partial.data_ptr(),
                  B, S, H, P, N, ns, slice_width(N), strides, int(x.dtype == torch.bfloat16))
    return y, h_final
