"""Binding of the fused LoRA matmul CUDA kernels (``csrc/lora_matmul.cu``),
the port of ``repro/kernels/lora_matmul.py``'s Pallas kernel, and the rule
that picks one of its three variants from the shapes and alignment:

* ``prefill`` (M > 16): TMA + wgmma, output tiles 128 x ``prefill_tile_n``;
* ``decode`` (M <= 16): clusters of ``decode_split`` blocks splitting K, x,
  A and W streamed by TMA through a ring whose size does not grow with K,
  the products on the tensor cores (operands swapped), slices of
  ``decode_tile_n`` columns;
* ``generic``: the first port's wmma kernel, for misaligned rows, ranks
  that are not a multiple of 8 and ranks above ``MAX_RANK`` (in chunks);
* ``fp32``: a tiled SIMT kernel for fp32 inputs (fp32 FMAs, no TF32), any
  shape and rank.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

MAX_RANK = 64  # prefill and decode hold u = x·A in at most 64 columns; above, generic
DECODE_MAX_M = 16  # the decode variant's rows: the n (8 or 16) of its wgmmas
SMS = 132  # streaming multiprocessors of an H100 SXM
SM_SMEM = 233_472  # an SM's shared memory; each block also reserves 1 KB
PREFILL_BM = 128
DECODE_MAX_SPLIT, DECODE_BK, DECODE_RANKS, DECODE_MAX_STAGES = 8, 64, 64, 6


def decode_tile_n(N: int) -> int:
    """Columns of a decode cluster's slice: 128 above N = 2048 halves the
    clusters of a wide N (mamba2's in_proj, N = 3352), 64 below keeps more
    SMs streaming W."""
    return 128 if N > 2048 else 64


def decode_split(K: int, N: int) -> int:
    """Blocks of a decode cluster, each a slice of K: about one block an SM
    over all the clusters of N's slices, at most 8 (a portable cluster) and
    no more than K has 64-row steps. A sweep of every served decode shape
    over splits 1-8 on the H100 put the fastest at ~100-180 blocks (PERF.md,
    PR 20): fewer leave SMs idle, more share SMs and pay more partials."""
    slices = math.ceil(N / decode_tile_n(N))
    return max(1, min(DECODE_MAX_SPLIT, round(SMS / slices), math.ceil(K / DECODE_BK)))


def decode_smem_bytes(M: int, K: int, N: int) -> int:
    """Shared memory of the decode blocks that compute this shape
    (csrc/lora_matmul.cu ``decode::Layout::smem``): a ring of stages of x
    (8 or 16 rows), A (64 ranks) and W (``decode_tile_n`` columns), each 64
    K-rows deep, one per K step of a block's slice of K (``decode_split``
    blocks split it), at most as many as leave room for two blocks an SM,
    at most 6."""
    mt, bn = (8 if M <= 8 else 16), decode_tile_n(N)
    stage = 2 * DECODE_BK * (mt + DECODE_RANKS + bn)
    fixed = 1024 + mt * bn * 4 + 2 * mt * DECODE_RANKS * 4 + 256
    steps = math.ceil(math.ceil(K / decode_split(K, N)) / DECODE_BK)
    fit = min(DECODE_MAX_STAGES, (SM_SMEM // 2 - 1024 - fixed) // stage)
    return fixed + min(steps, fit) * stage


def variant(M: int, K: int, N: int, r: int, aligned: bool, fp32: bool = False) -> str:
    """The variant that computes this shape. ``aligned``: every operand's
    pointer is 16-byte aligned (TMA needs it, and rows of K, N, r elements a
    multiple of 8). ``fp32``: the operands are fp32 (the others take bf16),
    whatever the shape."""
    if fp32:
        return "fp32"
    if aligned and K % 8 == 0 and N % 8 == 0 and r % 8 == 0 and r <= MAX_RANK:
        return "decode" if M <= DECODE_MAX_M else "prefill"
    return "generic"


def prefill_tile_n(M: int, N: int, r: int) -> int:
    """The prefill tile's width: the fewest waves of 128 x BN tiles over the
    card's SMs, each wave costing BN + 32 (the epilogue and pipeline fill);
    the wider tile on a tie. Rank above 16 leaves no registers for 256."""
    options = (64, 128, 192, 256) if r <= 16 else (64, 128, 192)
    rows = math.ceil(M / PREFILL_BM)

    def cost(bn):
        return math.ceil(rows * math.ceil(N / bn) / SMS) * (bn + 32), -bn

    return min(options, key=cost)


@functools.cache
def _entries():
    lib = _build.load("lora_matmul")
    args = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float]
    fns = {}
    for name, extra in (("prefill", [ctypes.c_int]), ("decode", [ctypes.c_int] * 2),
                        ("generic", []), ("fp32", [])):
        fn = getattr(lib, "lora_matmul_fp32" if name == "fp32" else f"lora_matmul_{name}_bf16")
        fn.argtypes = args + extra + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return lib, fns


@functools.lru_cache(maxsize=1024)
def plan(M: int, K: int, N: int, r: int, aligned: bool, fp32: bool = False) -> tuple[str, tuple]:
    """The variant of a shape and its extra launch arguments (looked up once
    per shape: the decode loop calls the same few shapes hundreds of times)."""
    kind = variant(M, K, N, r, aligned, fp32)
    extra = {"prefill": (prefill_tile_n(M, N, r),),
             "decode": (decode_tile_n(N), decode_split(K, N))}
    return kind, extra.get(kind, ())


def lora_matmul_cuda(x, w, a, b, scale: float, kind: str, extra: tuple = ()):
    """x (M,K), w (K,N), a (K,r), b (r,N): contiguous, bf16 (fp32 for the
    ``fp32`` variant), on one CUDA device; ``kind`` and ``extra`` from ``plan``."""
    lib, fns = _entries()
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _build.launch(lib, fns[kind], f"lora_matmul ({kind})", x.device, x.data_ptr(), w.data_ptr(),
                  a.data_ptr(), b.data_ptr(), y.data_ptr(), M, K, N, r, float(scale), *extra)
    return y
