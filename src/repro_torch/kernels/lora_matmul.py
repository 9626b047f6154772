"""Binding of the fused LoRA matmul CUDA kernels (``csrc/lora_matmul.cu``),
the port of ``repro/kernels/lora_matmul.py``'s Pallas kernel, and the rule
that picks one of its three variants from the dtype, shapes and alignment:

* ``prefill`` (bf16, M > 16): TMA + wgmma, output tiles 128 x
  ``prefill_tile_n``;
* ``decode`` (bf16, M <= 16): clusters of ``decode_split`` blocks splitting
  K, x, A and W streamed by TMA through a ring whose size does not grow with
  K, the products on the tensor cores (operands swapped), slices of
  ``decode_tile_n`` columns;
  both take any shape, rank and alignment: at r % 8 != 0 (A's rows are not
  16 bytes apart, so no tensor map reads them) the producer warps copy A's
  tiles themselves (``copy_a``), and where x, W or B cannot be read by a
  tensor map (a pointer off 16 bytes, K or N % 8 != 0) theirs too, the
  output then by plain stores at N % 8 != 0 (``copied``: the prefill's tile
  at most 128 wide); above ``FUSED_RANK`` both take two launches: u's two
  bf16 terms once, into scratch of ``scratch_ranks(r)`` a row, then the
  product with the fold as extra steps of its ring;
* ``fp32`` (fp32 inputs, any shape, rank and alignment): at M <= 16
  clusters of ``fp32_decode_split`` blocks split K as the bf16 decode's do,
  CUDA-core FMAs fed by a ring of TMA or cp.async stages; above 16 rows a
  SIMT tile for launch-bound shapes at up to ``FP32_ONE_LAUNCH_RANK``
  ranks, and from ``FP32_TWO_LAUNCH_WORK`` or above that rank two launches:
  u once (scale·u in fp32 scratch), then the product over K + r rows in
  3xTF32 on the tensor cores, ``fp32_tile_n`` columns a tile; above
  ``FUSED_RANK`` every shape takes two launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

# prefill, decode and fp32 compute u = x·A beside x·W, in one launch, up to
# FUSED_RANK ranks; above, u once in a launch of its own (in scratch the
# wrapper allocates), then the product
FUSED_RANK = 64
DECODE_MAX_M = 16  # the decode designs' rows: the n (8 or 16) of the bf16 wgmmas
SMS = 132  # streaming multiprocessors of an H100 SXM
SM_SMEM = 233_472  # an SM's shared memory; each block also reserves 1 KB
PREFILL_BM = 128
DECODE_MAX_SPLIT, DECODE_BK, DECODE_RANKS, DECODE_MAX_STAGES = 8, 64, 64, 6
COPY_A_STAGING = 64 * 16 * (DECODE_RANKS // 8 + 1)  # csrc ``atile::Tile<64>::STAGING``
FP32_BK, FP32_BN, FP32_MAX_STAGES = 32, 64, 6  # the fp32 decode's ring step and slice
# fp32 prefill shapes take one launch (the SIMT tile, u fused) only below
# this M·K·N and at up to FP32_ONE_LAUNCH_RANK ranks; else two: u once, then
# the product on the tensor cores in 3xTF32. A sweep on the card
# (``compare_kernels.py --sweep``; PERF.md, PR 25) found two launches faster
# in device time at every shape, and one faster in event time only where
# the call is launch-bound (M·K·N up to 2^23 at rank 16; two from 2^24.2)
FP32_TWO_LAUNCH_WORK, FP32_ONE_LAUNCH_RANK = 2 ** 24, 16


def scratch_ranks(r: int) -> int:
    """Ranks of a row of the bf16 u scratch above ``FUSED_RANK``: r rounded
    up to a multiple of 8, so that the product's tensor map (16-byte
    strides) reads it; the u launch writes zeros past r."""
    return -(-r // 8) * 8


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


def _decode_smem(M: int, N: int, fused: bool, steps: int, copy_a: bool = False) -> int:
    """csrc/lora_matmul.cu ``decode::Layout::smem`` for a block of at most
    ``steps`` ring steps: stages of x (8 or 16 rows), A (64 ranks; only
    ``fused``) and W (``decode_tile_n(N)`` columns), each 64 K-rows deep, and
    (``copy_a``) the staging rows of A's copied tile, no more than the block
    has steps and no more than leave room for two blocks an SM, at most 6,
    beside the fp32 partials of x·W (and of u, ``fused``)."""
    mt, bn = (8 if M <= 8 else 16), decode_tile_n(N)
    stage = 2 * DECODE_BK * (mt + (DECODE_RANKS if fused else 0) + bn)
    stage += COPY_A_STAGING if copy_a else 0
    fixed = 1024 + mt * bn * 4 + (2 * mt * DECODE_RANKS * 4 if fused else 0) + 256
    fit = min(DECODE_MAX_STAGES, (SM_SMEM // 2 - 1024 - fixed) // stage)
    return fixed + min(steps, fit) * stage


def decode_smem_bytes(M: int, K: int, N: int, r: int = 16) -> int:
    """Shared memory of the decode blocks that compute this shape's product
    (``_decode_smem``): up to ``FUSED_RANK`` A's tile rides in the ring
    (copied where r % 8 != 0) and a block's steps are its K steps
    (``decode_split`` blocks split K); above, the ring holds x and W alone,
    and a block's steps are at most its K steps and its share of the fold's
    2·ceil(r/64) steps (the terms of u against B's rows). The u launch
    before it: ``decode_u_smem_bytes``."""
    split = decode_split(K, N)
    steps = math.ceil(math.ceil(K / split) / DECODE_BK)
    if r > FUSED_RANK:
        steps += math.ceil(2 * math.ceil(r / DECODE_BK) / split)
    return _decode_smem(M, N, r <= FUSED_RANK, steps, r <= FUSED_RANK and r % 8 != 0)


def decode_u_smem_bytes(M: int, K: int, r: int) -> int:
    """Shared memory of the blocks of the decode's u launch above
    ``FUSED_RANK`` (u = x·A: A in W's place, N = ``scratch_ranks(r)``, its K
    split by ``decode_split`` of that N; A's tiles copied where r % 8 != 0)."""
    r8 = scratch_ranks(r)
    steps = math.ceil(math.ceil(K / decode_split(K, r8)) / DECODE_BK)
    return _decode_smem(M, r8, False, steps, r % 8 != 0)


def fp32_decode_split(K: int, N: int) -> int:
    """Blocks of an fp32 decode cluster, each a slice of the reduction's K
    rows: about two blocks an SM (each streams its rows of a 64-column
    slice of W through a ring of cp.async stages) over the clusters of N's
    slices, at most 8 and no more than K has 32-row steps."""
    slices = math.ceil(N / FP32_BN)
    return max(1, min(DECODE_MAX_SPLIT, round(2 * SMS / slices), math.ceil(K / FP32_BK)))


def fp32_decode_smem_bytes(M: int, r: int = 16) -> int:
    """csrc/lora_matmul.cu ``fp32::Dec::SMEM``: stages of 32 rows of x (4, 8
    or 16 rows, fp32), of W (64 columns) and of A (the fused u's 16, 32 or
    64 ranks; none above ``FUSED_RANK``), as many as leave room for two
    blocks an SM and at most 6, or the warps' partials after the loop if
    more, beside the block's partials of x·W and u, the whole u, the
    slots' barriers (W by TMA) and the slack that aligns the ring to 128
    bytes."""
    mt = 4 if M <= 4 else 8 if M <= 8 else 16
    rc = 0 if r > FUSED_RANK else 16 if r <= 16 else 32 if r <= 32 else 64
    stage = FP32_BK * (mt + FP32_BN + rc)
    red = 4 * mt * FP32_BN + 4 * mt * rc
    fixed = mt * FP32_BN + 2 * mt * rc
    slack = 8 * FP32_MAX_STAGES + 128
    fit = min(FP32_MAX_STAGES, (SM_SMEM // 2 - 1024 - slack - 4 * fixed) // (4 * stage))
    return 4 * (max(fit * stage, red) + fixed) + slack


def fp32_tile_n(M: int, N: int) -> int:
    """The fp32 product's tile width in two launches: 128 columns, or 64
    where 128-wide tiles would fill at most half the card's SMs (n = 64
    wgmmas ran 10-45% slower on the card than n = 128 wherever 128-wide
    tiles filled it)."""
    return 64 if math.ceil(M / PREFILL_BM) * math.ceil(N / 128) <= SMS // 2 else 128


def variant(M: int, K: int, N: int, r: int, aligned: bool, fp32: bool = False) -> str:
    """The variant that computes this shape: ``fp32`` for fp32 operands,
    else ``decode`` up to ``DECODE_MAX_M`` rows and ``prefill`` above, at any
    K, N, r and alignment (``aligned``: x's, W's and B's pointers are
    16-byte aligned; where they are not, or K or N % 8 != 0, the variants
    copy the tiles TMA cannot read: ``copied``)."""
    if fp32:
        return "fp32"
    return "decode" if M <= DECODE_MAX_M else "prefill"


def copied(K: int, N: int, aligned: bool) -> bool:
    """Whether a bf16 launch copies x's, W's or B's tiles (a tensor map
    cannot read them: a pointer off 16 bytes, rows of K or N elements not a
    multiple of 8), four placing warps beside the consumers."""
    return not aligned or K % 8 != 0 or N % 8 != 0


def prefill_tile_n(M: int, N: int, r: int, copy: bool = False) -> int:
    """The prefill tile's width: the fewest waves of 128 x BN tiles over the
    card's SMs, each wave costing BN + 32 (the epilogue and pipeline fill);
    the wider tile on a tie. Ranks 17-64 (u's accumulators beside the
    tile's) leave no registers for 256; above ``FUSED_RANK`` the product's
    tile holds the output alone. ``copy`` (``copied``): 128, the widest the
    four placing warps leave registers for (a copied x tile serves the
    wider tile's work: 64 ran slower on the card)."""
    if copy:
        return 128
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
    # prefill: bn, copy_a, u; decode: bn, split, usplit, copy_a, u;
    # fp32: split, usplit, bn, tma, u
    for name, extra in (("prefill", [ctypes.c_int] * 2 + [ctypes.c_void_p]),
                        ("decode", [ctypes.c_int] * 4 + [ctypes.c_void_p]),
                        ("fp32", [ctypes.c_int] * 4 + [ctypes.c_void_p])):
        fn = getattr(lib, "lora_matmul_fp32" if name == "fp32" else f"lora_matmul_{name}_bf16")
        fn.argtypes = args + extra + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return lib, fns


@functools.lru_cache(maxsize=1024)
def plan(M: int, K: int, N: int, r: int, aligned: bool, fp32: bool = False) -> tuple[str, tuple]:
    """The variant of a shape and its extra launch arguments (looked up once
    per shape: the decode loop calls the same few shapes hundreds of times):
    prefill: the tile width (at most 128 where tiles are ``copied``) and
    whether the producers copy A (r % 8 != 0; the kernel also copies it,
    and x's, W's and B's tiles, wherever a tensor map cannot read them);
    decode: the slice width, the cluster's split of K, that of the u launch
    above ``FUSED_RANK`` (N = ``scratch_ranks(r)``; else 0) and whether the
    producer copies A; fp32: the decode design's cluster split at M <= 16 (0:
    the prefill design), its u launch's (else 0), the prefill's product's
    tile width in two launches (else 0), whether the decode design reads W
    (A in its u launch) by TMA where it can (always: a sweep on the card,
    ``compare_kernels.py --sweep``, found TMA no slower than cp.async at any
    size of W; 0 makes it take cp.async) and whether u takes a launch of its
    own (above ``FUSED_RANK``; at prefill above ``FP32_ONE_LAUNCH_RANK`` and
    from ``FP32_TWO_LAUNCH_WORK``)."""
    kind = variant(M, K, N, r, aligned, fp32)
    high, copy_a = r > FUSED_RANK, int(r % 8 != 0)
    if kind == "fp32":
        if M > DECODE_MAX_M:
            two = r > FP32_ONE_LAUNCH_RANK or M * K * N >= FP32_TWO_LAUNCH_WORK
            return kind, (0, 0, fp32_tile_n(M, N) if two else 0, 0, int(two))
        return kind, (fp32_decode_split(K + (r if high else 0), N),
                      fp32_decode_split(K, r) if high else 0, 0, 1, int(high))
    if kind == "prefill":
        return kind, (prefill_tile_n(M, N, r, copied(K, N, aligned)), copy_a)
    return kind, (decode_tile_n(N), decode_split(K, N),
                  decode_split(K, scratch_ranks(r)) if high else 0, copy_a)


def lora_matmul_cuda(x, w, a, b, scale: float, kind: str, extra: tuple = (), out=None):
    """x (M,K), w (K,N), a (K,r), b (r,N): contiguous, bf16 (fp32 for the
    ``fp32`` variant), on one CUDA device; ``kind`` and ``extra`` from ``plan``.
    ``out``: a contiguous (M, N) tensor to write y into (else allocated).
    Above ``FUSED_RANK`` prefill and decode take scratch for the two bf16
    terms h + l of scale·u, (2, M, ``scratch_ranks(r)``), and fp32 in two
    launches for scale·u, (M, r), written by their first launch."""
    lib, fns = _entries()
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device) if out is None else out
    if kind == "fp32":
        extra, two = extra[:4], extra[4]
        u = torch.empty((M, r), dtype=x.dtype, device=x.device) if two else None
    else:
        u = None
        if r > FUSED_RANK:
            u = torch.empty((2, M, scratch_ranks(r)), dtype=x.dtype, device=x.device)
    scratch = (None if u is None else u.data_ptr(),)
    _build.launch(lib, fns[kind], f"lora_matmul ({kind})", x.device, x.data_ptr(), w.data_ptr(),
                  a.data_ptr(), b.data_ptr(), y.data_ptr(), M, K, N, r, float(scale), *extra,
                  *scratch)
    return y
