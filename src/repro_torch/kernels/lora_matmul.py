"""Binding of the fused LoRA matmul CUDA kernels (``csrc/lora_matmul.cu``),
the port of ``repro/kernels/lora_matmul.py``'s Pallas kernel, and the rule
that picks one of its three variants from the shapes and alignment:

* ``prefill`` (M > 16): TMA + wgmma, output tiles 128 x ``prefill_tile_n``;
* ``decode`` (M <= 16): clusters of ``decode_split`` blocks splitting K, x,
  A and W streamed by TMA through a ring whose size does not grow with K,
  the products on the tensor cores (operands swapped), slices of
  ``decode_tile_n`` columns;
  above ``FUSED_RANK`` both take two launches: u's two bf16 terms once,
  then the product with the fold as extra steps of its ring;
* ``generic``: the first port's wmma kernel, for misaligned rows, K, N or r
  not a multiple of 8, and ranks above ``MAX_RANK`` (in chunks);
* ``fp32``: a tiled SIMT kernel for fp32 inputs (fp32 FMAs, no TF32), any
  shape and rank.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

# prefill and decode compute u = x·A beside x·W, in one launch, up to
# FUSED_RANK ranks; above, up to MAX_RANK, u once in a launch of its own (in
# scratch the wrapper allocates), then the product; above MAX_RANK, generic
FUSED_RANK, MAX_RANK = 64, 256
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


def _decode_smem(M: int, N: int, fused: bool, steps: int) -> int:
    """csrc/lora_matmul.cu ``decode::Layout::smem`` for a block of at most
    ``steps`` ring steps: stages of x (8 or 16 rows), A (64 ranks; only
    ``fused``) and W (``decode_tile_n(N)`` columns), each 64 K-rows deep, no
    more than the block has steps and no more than leave room for two blocks
    an SM, at most 6, beside the fp32 partials of x·W (and of u, ``fused``)."""
    mt, bn = (8 if M <= 8 else 16), decode_tile_n(N)
    stage = 2 * DECODE_BK * (mt + (DECODE_RANKS if fused else 0) + bn)
    fixed = 1024 + mt * bn * 4 + (2 * mt * DECODE_RANKS * 4 if fused else 0) + 256
    fit = min(DECODE_MAX_STAGES, (SM_SMEM // 2 - 1024 - fixed) // stage)
    return fixed + min(steps, fit) * stage


def decode_smem_bytes(M: int, K: int, N: int, r: int = 16) -> int:
    """Shared memory of the decode blocks that compute this shape's product
    (``_decode_smem``): up to ``FUSED_RANK`` A's tile rides in the ring and
    a block's steps are its K steps (``decode_split`` blocks split K); above,
    the ring holds x and W alone, and a block's steps are at most its K
    steps and its share of the fold's 2·ceil(r/64) steps (the terms of u
    against B's rows). The u launch before it: ``decode_u_smem_bytes``."""
    split = decode_split(K, N)
    steps = math.ceil(math.ceil(K / split) / DECODE_BK)
    if r > FUSED_RANK:
        steps += math.ceil(2 * math.ceil(r / DECODE_BK) / split)
    return _decode_smem(M, N, r <= FUSED_RANK, steps)


def decode_u_smem_bytes(M: int, K: int, r: int) -> int:
    """Shared memory of the blocks of the decode's u launch above
    ``FUSED_RANK`` (u = x·A: A in W's place, N = r, its K split by
    ``decode_split(K, r)``)."""
    return _decode_smem(M, r, False, math.ceil(math.ceil(K / decode_split(K, r)) / DECODE_BK))


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
    the wider tile on a tie. Ranks 17-64 (u's accumulators beside the
    tile's) leave no registers for 256; above ``FUSED_RANK`` the product's
    tile holds the output alone."""
    options = (64, 128, 192) if 16 < r <= FUSED_RANK else (64, 128, 192, 256)
    rows = math.ceil(M / PREFILL_BM)

    def cost(bn):
        return math.ceil(rows * math.ceil(N / bn) / SMS) * (bn + 32), -bn

    return min(options, key=cost)


@functools.cache
def _entries():
    lib = _build.load("lora_matmul")
    args = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float]
    fns = {}
    # prefill: bn, u; decode: bn, split, usplit, u
    for name, extra in (("prefill", [ctypes.c_int, ctypes.c_void_p]),
                        ("decode", [ctypes.c_int] * 3 + [ctypes.c_void_p]),
                        ("generic", []), ("fp32", [])):
        fn = getattr(lib, "lora_matmul_fp32" if name == "fp32" else f"lora_matmul_{name}_bf16")
        fn.argtypes = args + extra + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return lib, fns


@functools.lru_cache(maxsize=1024)
def plan(M: int, K: int, N: int, r: int, aligned: bool, fp32: bool = False) -> tuple[str, tuple]:
    """The variant of a shape and its extra launch arguments (looked up once
    per shape: the decode loop calls the same few shapes hundreds of times):
    prefill: the tile width; decode: the slice width, the cluster's split of
    K and, above ``FUSED_RANK``, that of the u launch (N = r; else 0)."""
    kind = variant(M, K, N, r, aligned, fp32)
    usplit = decode_split(K, r) if r > FUSED_RANK else 0
    extra = {"prefill": (prefill_tile_n(M, N, r),),
             "decode": (decode_tile_n(N), decode_split(K, N), usplit)}
    return kind, extra.get(kind, ())


def lora_matmul_cuda(x, w, a, b, scale: float, kind: str, extra: tuple = ()):
    """x (M,K), w (K,N), a (K,r), b (r,N): contiguous, bf16 (fp32 for the
    ``fp32`` variant), on one CUDA device; ``kind`` and ``extra`` from ``plan``.
    Above ``FUSED_RANK`` prefill and decode take scratch for the two bf16
    terms h + l of scale·u, (2, M, r), written by their first launch."""
    lib, fns = _entries()
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    scratch = ()
    if kind in ("prefill", "decode"):
        u = torch.empty((2, M, r), dtype=x.dtype, device=x.device) if r > FUSED_RANK else None
        scratch = (None if u is None else u.data_ptr(),)
    _build.launch(lib, fns[kind], f"lora_matmul ({kind})", x.device, x.data_ptr(), w.data_ptr(),
                  a.data_ptr(), b.data_ptr(), y.data_ptr(), M, K, N, r, float(scale), *extra,
                  *scratch)
    return y
