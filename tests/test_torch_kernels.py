"""The port's kernels against the reference's Pallas kernels.

On the CPU the port's wrappers run their plain versions; these are held
against the JAX Pallas kernels (interpret mode, as ``test_kernels.py`` runs
them) and the reference's plain versions, on the same numpy-seeded inputs.
The CUDA kernels themselves are held against their plain versions on the
card by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn_ops import flash_attention as jax_flash_attention
from repro.kernels.attn_ref import flash_attention_ref as jax_flash_attention_ref
from repro.kernels.flash_attention import flash_attention_pallas as jax_flash_attention_pallas
from repro.kernels.lora_ops import lora_matmul as jax_lora_matmul
from repro.kernels.lora_ref import lora_matmul_ref as jax_lora_matmul_ref
from repro.models import layers as jax_layers
from repro_torch.kernels.attn_ops import flash_attention
from repro_torch.kernels import attn_ref
from repro_torch.kernels.attn_ref import flash_attention_ref, flash_attention_tf32x3_ref
from repro_torch.kernels import flash_attention as flash_binding
from repro_torch.kernels import lora_matmul as lora_binding
from repro_torch.kernels.lora_ops import lora_matmul
from repro_torch.kernels.lora_ref import (lora_matmul_fp32_split_ref, lora_matmul_ref,
                                          lora_matmul_split_ref)
from repro_torch.config import LoRAConfig, get_arch
from repro_torch.models import layers as torch_layers
from repro_torch.models import mamba2

# fp32: both sides accumulate in fp32 in another order; bf16: one bf16 ulp of
# outputs of magnitude ~1-4 (the reference's own kernel tolerances)
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounding is
    round-to-nearest-even on both sides)."""
    return jnp.asarray(a, JNP[dtype]), torch.from_numpy(a).to(TORCH[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# LoRA fused matmul
# ---------------------------------------------------------------------------

# the cases of test_kernels.py's LORA_CASES: (M, K, N, r, dtype)
LORA_CASES = [
    (128, 256, 128, 8, "float32"),
    (256, 512, 384, 16, "float32"),
    (64, 128, 256, 4, "bfloat16"),
    (100, 200, 300, 8, "float32"),  # non-aligned: the reference pads
    (32, 1024, 64, 32, "float32"),
    (8, 64, 8, 2, "float32"),  # tiny
    # ranks 72-256 (the Hopper variants' two-launch range), small M/K/N
    (128, 256, 128, 128, "float32"), (64, 128, 256, 256, "float32"),
    (128, 256, 128, 128, "bfloat16"), (64, 128, 256, 256, "bfloat16"),
    # ranks that are not a multiple of 8 (the copied A tiles), one and two
    # launches
    (64, 128, 256, 5, "float32"), (64, 128, 256, 5, "bfloat16"),
    (32, 256, 128, 100, "float32"), (32, 256, 128, 100, "bfloat16"),
]


def _lora_inputs(M, K, N, r, seed=0, b_scale=0.05):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K), np.float32),
            rng.standard_normal((K, N), np.float32) * 0.05,
            rng.standard_normal((K, r), np.float32) * 0.05,
            rng.standard_normal((r, N), np.float32) * b_scale)


@pytest.mark.parametrize("M,K,N,r,dtype", LORA_CASES)
def test_lora_plain_matches_pallas_and_ref(M, K, N, r, dtype):
    (jx, tx), (jw, tw), (ja, ta), (jb, tb) = (_pair(t, dtype) for t in _lora_inputs(M, K, N, r))
    y = lora_matmul(tx, tw, ta, tb, scale=2.0)
    assert y.dtype == TORCH[dtype] and y.shape == (M, N)
    tol = TOL[dtype]
    for ref in (jax_lora_matmul(jx, jw, ja, jb, scale=2.0),
                jax_lora_matmul_ref(jx, jw, ja, jb, scale=2.0)):
        np.testing.assert_allclose(_np(y), _np(ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(lora_matmul_ref(tx, tw, ta, tb, scale=2.0)), _np(y),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("M,K,N,r", [(128, 256, 128, 128), (64, 128, 256, 256)])
def test_lora_split_terms_match_pallas_and_ref(M, K, N, r):
    """The prefill kernel's arithmetic above 64 ranks (scale·u folded as two
    bf16 terms, ``lora_matmul_split_ref``) against the Pallas kernel in
    interpret mode and both plain versions. In bf16 within 2 bf16 ulps of
    the largest output of ``lora_matmul_ref`` (the card's tolerance); in
    fp32 within the terms' own bound, 2^-16 of Σ_j |scale·u_j|·|B_jn|."""
    (jx, tx), (jw, tw), (ja, ta), (jb, tb) = (_pair(t, "bfloat16")
                                              for t in _lora_inputs(M, K, N, r, seed=r))
    y = lora_matmul_split_ref(tx, tw, ta, tb, scale=2.0)
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    ref = lora_matmul_ref(tx, tw, ta, tb, scale=2.0)
    ulps = 2 * 2.0 ** -7 * _np(ref).__abs__().max()
    assert np.abs(_np(y) - _np(ref)).max() <= ulps
    for want in (jax_lora_matmul(jx, jw, ja, jb, scale=2.0),
                 jax_lora_matmul_ref(jx, jw, ja, jb, scale=2.0)):
        np.testing.assert_allclose(_np(y), _np(want), rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    x, w, a, b = (torch.from_numpy(t) for t in _lora_inputs(M, K, N, r, seed=r))
    v = 2.0 * (x.double() @ a.double())
    bound = 2.0 ** -16 * (v.abs() @ b.double().abs()).max().item()
    err = (lora_matmul_split_ref(x, w, a, b, scale=2.0).double()
           - (x.double() @ w.double() + v @ b.double())).abs().max().item()
    assert 0 < err <= bound + 1e-5 * (x.double() @ w.double()).abs().max().item(), (err, bound)


def test_lora_plain_leading_dims_and_zero_B():
    x, w, a, b = _lora_inputs(16, 64, 32, 4, seed=1, b_scale=0.0)
    (jx, tx), (jw, tw), (ja, ta), (jb, tb) = (_pair(t, "float32") for t in (x, w, a, b))
    y = lora_matmul(tx.reshape(2, 8, 64), tw, ta, tb, scale=4.0)
    assert y.shape == (2, 8, 32)
    ref = jax_lora_matmul(jx.reshape(2, 8, 64), jw, ja, jb, scale=4.0)
    np.testing.assert_allclose(_np(y), _np(ref), rtol=1e-5, atol=1e-5)
    # B = 0 (the LoRA init) -> exactly the frozen product's value
    np.testing.assert_allclose(_np(y).reshape(16, 32), x @ w, rtol=1e-5, atol=1e-5)


def test_lora_wrapper_rejects_bad_inputs():
    x, w, a, b = (torch.from_numpy(t) for t in _lora_inputs(8, 64, 32, 4))
    with pytest.raises(TypeError):
        lora_matmul(x, w.double(), a, b)
    with pytest.raises(ValueError):
        lora_matmul(x, w[:32], a, b)
    with pytest.raises(ValueError):
        lora_matmul(x, w.t().contiguous().t(), a, b)
    with pytest.raises(ValueError):
        lora_matmul(x, w, a, b.t())


@pytest.mark.parametrize("M,K,N,r,aligned,expected", [
    # every main-path shape: prefill (M = 8 x 512) and decode (M = 8)
    *[(M, K, N, 16, True, "prefill" if M > 16 else "decode")
      for M in (4096, 8) for K, N in ((768, 768), (768, 256), (768, 2048), (2048, 768),
                                      (768, 3352), (1536, 768))],
    (16, 768, 768, 16, True, "decode"), (17, 768, 768, 16, True, "prefill"),
    (1, 768, 768, 16, True, "decode"),
    (8, 768, 300, 16, True, "decode"),  # N % 8: W, B and y copied (once generic)
    (4096, 772, 768, 16, True, "prefill"),  # K % 8: x copied (once generic)
    (8, 768, 768, 1, True, "decode"), (4096, 768, 768, 5, True, "prefill"),  # r % 8: A copied
    (4096, 768, 768, 80, True, "prefill"),  # r above 64, a multiple of 8 (once generic)
    # ranks 72-256: prefill and decode, in two launches
    *[(M, K, N, r, True, "prefill" if M > 16 else "decode")
      for r in (72, 128, 256) for M in (4096, 16, 8) for K, N in ((768, 2048), (4096, 14336))],
    (4096, 768, 768, 264, True, "prefill"), (8, 768, 768, 264, True, "decode"),  # r above 256
    (4096, 768, 768, 100, True, "prefill"), (8, 768, 768, 100, True, "decode"),  # r % 8
    *[(M, 768, 2048, r, True, "prefill" if M > 16 else "decode")
      for r in (4, 7, 512) for M in (4096, 37, 8)],
    (8, 772, 768, 5, True, "decode"), (4096, 768, 300, 100, True, "prefill"),  # K % 8, N % 8
    (8, 768, 768, 128, False, "decode"),  # misaligned: copied (once generic)
    (8, 768, 768, 16, False, "decode"), (4096, 768, 768, 16, False, "prefill"),  # misaligned
    (8, 200_000, 768, 64, True, "decode"),  # the decode ring's size does not grow with K
])
def test_lora_variant_rule(M, K, N, r, aligned, expected):
    """The wrapper's choice of CUDA variant is a pure function of the shapes
    and the alignment, checked here without the card."""
    assert lora_binding.variant(M, K, N, r, aligned) == expected
    kind, extra = lora_binding.plan(M, K, N, r, aligned)
    assert kind == expected
    usplit = lora_binding.decode_split(K, lora_binding.scratch_ranks(r)) if r > 64 else 0
    copy_a = int(r % 8 != 0)
    copy = not aligned or K % 8 != 0 or N % 8 != 0
    assert lora_binding.copied(K, N, aligned) == copy
    want = {"prefill": (lora_binding.prefill_tile_n(M, N, r, copy), copy_a),
            "decode": (lora_binding.decode_tile_n(N), lora_binding.decode_split(K, N), usplit,
                       copy_a)}
    assert extra == want.get(kind, ())


@pytest.mark.parametrize("r,r8", [(1, 8), (5, 8), (8, 8), (63, 64), (100, 104), (264, 264),
                                  (512, 512), (1023, 1024)])
def test_lora_scratch_ranks_pad_u_to_a_multiple_of_8(r, r8):
    """Above 64 ranks the bf16 u scratch is (2, M, r8): rows of r8 ranks are
    16-byte strided, so the product's tensor map reads them; B keeps r rows."""
    assert lora_binding.scratch_ranks(r) == r8


@pytest.mark.parametrize("M,K,N,r,extra", [
    # the decode design at M <= 16: clusters of fp32_decode_split blocks, W by
    # TMA (where it can)
    (8, 768, 768, 16, (8, 0, 0, 1, 0)), (8, 2048, 768, 16, (8, 0, 0, 1, 0)),
    (8, 768, 2048, 16, (8, 0, 0, 1, 0)), (8, 768, 256, 16, (8, 0, 0, 1, 0)),
    (1, 768, 768, 5, (8, 0, 0, 1, 0)), (16, 768, 300, 64, (8, 0, 0, 1, 0)),
    (4, 64, 64, 16, (2, 0, 0, 1, 0)),  # a smoke decode: no more blocks than K has 32-row steps
    (2, 3584, 14336, 16, (1, 0, 0, 1, 0)), (2, 14336, 3584, 16, (5, 0, 0, 1, 0)),  # gemma2-9b
    # above 64 ranks: u in a launch of its own (N = r), the product over K + r
    (8, 768, 768, 80, (8, 8, 0, 1, 1)), (8, 768, 768, 128, (8, 8, 0, 1, 1)),
    (2, 64, 64, 200, (8, 2, 0, 1, 1)), (8, 14336, 4096, 128, (4, 8, 0, 1, 1)),
    # the prefill design: one launch for launch-bound shapes at up to 16
    # ranks (the smoke configs'), two from FP32_TWO_LAUNCH_WORK (2^24) or
    # above 16 ranks, the product's tiles 128 or 64 wide
    (17, 768, 768, 16, (0, 0, 0, 0, 0)), (128, 64, 64, 16, (0, 0, 0, 0, 0)),
    (128, 296, 64, 16, (0, 0, 0, 0, 0)), (128, 256, 256, 16, (0, 0, 0, 0, 0)),
    (128, 384, 384, 16, (0, 0, 64, 0, 1)), (32, 768, 768, 16, (0, 0, 64, 0, 1)),
    (128, 64, 64, 17, (0, 0, 64, 0, 1)), (128, 64, 64, 64, (0, 0, 64, 0, 1)),
    (4096, 768, 256, 16, (0, 0, 64, 0, 1)),
    (4096, 768, 768, 16, (0, 0, 128, 0, 1)), (4096, 2048, 768, 16, (0, 0, 128, 0, 1)),
    (4096, 768, 2048, 16, (0, 0, 128, 0, 1)), (4096, 768, 2048, 128, (0, 0, 128, 0, 1)),
    (37, 96, 130, 100, (0, 0, 64, 0, 1)), (16384, 3584, 14336, 16, (0, 0, 128, 0, 1)),
])
def test_lora_fp32_plan(M, K, N, r, extra):
    assert lora_binding.plan(M, K, N, r, True, True) == ("fp32", extra)
    assert lora_binding.plan(M, K, N, r, False, True) == ("fp32", extra)  # any alignment


@pytest.mark.parametrize("K,N,split", [
    (768, 768, 8), (2048, 768, 8), (768, 2048, 8), (768, 256, 8),  # fedsllm-100m: 96-256 blocks
    (64, 64, 2), (40, 24, 2),  # no more blocks than K has 32-row steps
    (3584, 14336, 1), (14336, 3584, 5), (18432, 4608, 4),  # 224, 280 and 288 blocks
])
def test_lora_fp32_decode_split_gives_about_two_blocks_an_sm(K, N, split):
    assert lora_binding.fp32_decode_split(K, N) == split


@pytest.mark.parametrize("M,r,smem", [
    # stages of 32 rows of x (4, 8 or 16 rows), W (64 columns) and A (16, 32
    # or 64 ranks), 6 or as many as leave room for two blocks an SM, beside
    # the partials of x·W and u, the whole u, the 6 slots' barriers and the
    # 128 bytes that align the ring for TMA
    (4, 16, 4 * (6 * 32 * (4 + 64 + 16) + 4 * 64 + 2 * 4 * 16) + 176),
    (8, 16, 4 * (6 * 32 * (8 + 64 + 16) + 8 * 64 + 2 * 8 * 16) + 176),
    (8, 5, 4 * (6 * 32 * (8 + 64 + 16) + 8 * 64 + 2 * 8 * 16) + 176),
    (16, 64, 4 * (5 * 32 * (16 + 64 + 64) + 16 * 64 + 2 * 16 * 64) + 176),
    (16, 33, 4 * (6 * 32 * (16 + 64 + 64) + 16 * 64 + 2 * 16 * 64) + 176),
    (8, 128, 4 * (6 * 32 * (8 + 64) + 8 * 64) + 176),  # above 64 ranks: no A, no u
])
def test_lora_fp32_decode_smem_matches_the_kernel_layout(M, r, smem):
    """fp32_decode_smem_bytes mirrors csrc/lora_matmul.cu fp32::Dec::SMEM,
    and two blocks fit on an SM (each also reserves 1 KB)."""
    got = lora_binding.fp32_decode_smem_bytes(M, r)
    assert 2 * (got + 1024) <= 233_472
    if (M, r) != (16, 33):
        assert got == smem
    else:  # 6 stages of 64 ranks do not fit two blocks: 5, as at r = 64
        assert got == lora_binding.fp32_decode_smem_bytes(16, 64) < smem


@pytest.mark.parametrize("M,K,N,r,dtype", [
    (8, 768, 300, 16, "float32"), (2, 777, 130, 5, "float32"), (16, 200, 64, 100, "float32"),
    (1, 96, 64, 64, "float32"),
])
def test_lora_fp32_decode_order_matches_pallas_and_ref(M, K, N, r, dtype):
    """The fp32 decode design sums in a fixed order (the cluster's K slices,
    each warp's rows of every step; above 64 ranks [x | scale·u]·[W; B]):
    its plain mirror against the Pallas kernel in interpret mode and both
    plain versions at the reference's fp32 tolerance."""
    (jx, tx), (jw, tw), (ja, ta), (jb, tb) = (_pair(t, dtype) for t in _lora_inputs(M, K, N, r))
    split, usplit = lora_binding.plan(M, K, N, r, True, True)[1][:2]
    y = lora_matmul_fp32_split_ref(tx, tw, ta, tb, scale=2.0, split=split,
                                   usplit=max(usplit, 1))
    for want in (jax_lora_matmul(jx, jw, ja, jb, scale=2.0),
                 jax_lora_matmul_ref(jx, jw, ja, jb, scale=2.0)):
        np.testing.assert_allclose(_np(y), _np(want), rtol=TOL[dtype], atol=TOL[dtype])
    ref = lora_matmul_ref(tx, tw, ta, tb, scale=2.0)
    assert (y - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("N,r,expected", [
    (256, 16, 64), (768, 16, 192), (2048, 16, 256), (3352, 16, 192),
    (2048, 64, 128),  # no 256-wide tile from rank 17 to 64
    # above 64 ranks the product's tile holds the output alone: 256 again
    (2048, 128, 256), (2048, 256, 256), (256, 128, 64), (768, 256, 192), (14336, 128, 256),
])
def test_lora_prefill_tile_fills_the_card(N, r, expected):
    """At M = 4096 (32 row tiles) the tile width puts the grid in the fewest
    waves over 132 SMs; N = 768 at 192 is one wave of 128 tiles."""
    bn = lora_binding.prefill_tile_n(4096, N, r)
    assert bn == expected
    if N in (256, 768):
        assert 32 * -(-N // bn) == 128  # one wave


@pytest.mark.parametrize("M,K,N,r,aligned,expected", [
    (4096, 768, 2048, 16, False, 128), (4096, 772, 2048, 16, True, 128),  # x copied: 256 → 128
    (4096, 768, 256, 16, False, 128), (4096, 768, 3350, 16, True, 128),  # 64 without copies
    (4096, 768, 300, 64, True, 128),
    (4096, 768, 2048, 16, True, 256),  # nothing copied: the widest tile
])
def test_lora_prefill_tile_with_copied_tiles(M, K, N, r, aligned, expected):
    """Where the producers copy x's, W's or B's tiles (four placing warps
    beside the consumers), the prefill's tile is 128 wide: the widest their
    registers leave room for."""
    assert lora_binding.copied(K, N, aligned) == (not aligned or K % 8 != 0 or N % 8 != 0)
    assert lora_binding.plan(M, K, N, r, aligned)[1][0] == expected


@pytest.mark.parametrize("K,r,usplit", [
    (768, 72, 8), (768, 128, 8), (768, 256, 8), (4096, 128, 8), (4096, 256, 8),
    (256, 128, 4),  # no more blocks than K has 64-row steps
])
def test_lora_decode_u_launch_split(K, r, usplit):
    """Above 64 ranks the decode's first launch (u = x·A, N = r) splits K
    by the same rule as any decode shape: its 2-4 slices of 64 ranks take
    clusters of 8 blocks at every K of 8 steps or more."""
    _, extra = lora_binding.plan(8, K, 2048, r, True)
    assert extra[2] == lora_binding.decode_split(K, r) == usplit
    assert lora_binding.plan(8, K, 2048, 64, True)[1][2] == 0  # one launch up to 64


def test_lora_decode_slice_width():
    assert [lora_binding.decode_tile_n(N) for N in (256, 768, 2048, 3352)] == [64, 64, 64, 128]


@pytest.mark.parametrize("K,N,split", [
    (768, 768, 8), (768, 2048, 4), (256, 768, 4),  # fedsllm-100m; a K of 4 steps
    (18432, 4608, 4), (22528, 8192, 2),  # starcoder2's and command-r's w_down: 144, 128 blocks
    (3584, 14336, 1), (8192, 22528, 1),  # gemma2's and command-r's w_up: 112, 176 blocks
])
def test_lora_decode_split_gives_about_one_block_an_sm(K, N, split):
    """The decode cluster splits K into as many blocks as give the clusters
    of N's slices about one block on each of the 132 SMs."""
    assert lora_binding.decode_split(K, N) == split


def test_lora_decode_smem_matches_the_kernel_layout():
    """decode_smem_bytes mirrors csrc/lora_matmul.cu decode::Layout::smem:
    stages of x (8 or 16 rows), A (64 ranks) and W (64 or 128 columns), each
    64 K-rows of bf16, beside the fp32 partials, barriers and alignment
    slack. M=8, K=N=768 -> 64-column slices, a cluster of 8, a 128-row slice
    of K a block, 2 stages; K=18432 -> the 6 stages of 64 columns that leave
    room for two blocks on an SM (each also reserves 1 KB), as every long K
    does, whatever its length."""
    stage = 64 * 8 * 2 + 64 * 64 * 2 + 64 * 64 * 2
    fixed = 1024 + 8 * 64 * 4 + 2 * 8 * 64 * 4 + 256
    assert lora_binding.decode_smem_bytes(8, 768, 768) == fixed + 2 * stage
    assert lora_binding.decode_smem_bytes(8, 18432, 768) == fixed + 6 * stage == 111_872
    for M in (1, 8, 9, 16):
        for N in (768, 4608, 22528):  # 64- and 128-column slices
            smem = lora_binding.decode_smem_bytes(M, 200_000, N)
            assert 2 * (smem + 1024) <= 233_472
            assert smem == lora_binding.decode_smem_bytes(M, 100_000, N)


@pytest.mark.parametrize("r,copied", [(5, True), (63, True), (16, False)])
def test_lora_decode_smem_with_copied_a(r, copied):
    """At r % 8 != 0 the decode's stages also hold the staging rows of A's
    copied tile (64 rows of 144 bytes: a K-row's 64 ranks may straddle 9
    16-byte chunks). M=8, K=N=768: 2 steps a block; K=18432: as many stages
    as leave room for two blocks an SM, 4 (6 without the copy)."""
    stage = 64 * 8 * 2 + 64 * 64 * 2 + 64 * 64 * 2 + (64 * 144 if copied else 0)
    fixed = 1024 + 8 * 64 * 4 + 2 * 8 * 64 * 4 + 256
    assert lora_binding.decode_smem_bytes(8, 768, 768, r) == fixed + 2 * stage
    assert lora_binding.decode_smem_bytes(8, 18432, 768, r) == fixed + (4 if copied else 6) * stage
    for M in (1, 8, 9, 16):
        for N in (768, 4608, 22528):
            assert 2 * (lora_binding.decode_smem_bytes(M, 200_000, N, r) + 1024) <= 233_472


@pytest.mark.parametrize("r,copied", [(100, True), (264, False), (512, False), (1023, True)])
def test_lora_decode_u_smem_at_any_rank(r, copied):
    """The decode's u launch above 64 ranks: N = r8 columns (A in W's place,
    copied at r % 8 != 0), its K split by decode_split of r8; two blocks an
    SM at every K."""
    r8 = lora_binding.scratch_ranks(r)
    split = lora_binding.decode_split(768, r8)
    stage = 64 * 8 * 2 + 64 * 64 * 2 + (64 * 144 if copied else 0)
    fixed = 1024 + 8 * 64 * 4 + 256
    steps = -(-(-(-768 // split)) // 64)
    assert lora_binding.decode_u_smem_bytes(8, 768, r) == fixed + steps * stage
    for M in (1, 8, 16):
        assert 2 * (lora_binding.decode_u_smem_bytes(M, 200_000, r) + 1024) <= 233_472
    assert 2 * (lora_binding.decode_smem_bytes(16, 200_000, 22528, r) + 1024) <= 233_472


@pytest.mark.parametrize("r", [128, 256])
def test_lora_decode_smem_above_64_ranks(r):
    """Above 64 ranks both decode launches stream x (or u's terms) and their
    W (A for u = x·A, with N = r; W, then B's rows in the fold's steps)
    alone: stages of 64 K-rows of x and of 64 or 128 columns, no A tile
    and no u partials. M=8, K=N=768: a cluster of 8, a 128-row slice of K a
    block, plus at most one of the fold's 4 (r=128) or 8 (r=256) steps: 3
    stages; the u launch 2. A long K: the 6-stage cap (W's bytes in flight
    as at 64 ranks); 16 rows and 128-column slices: the 5 stages that leave
    room for two blocks an SM (3 with A's tile)."""
    stage = 64 * 8 * 2 + 64 * 64 * 2
    fixed = 1024 + 8 * 64 * 4 + 256
    assert lora_binding.decode_smem_bytes(8, 768, 768, r) == fixed + 3 * stage
    assert lora_binding.decode_u_smem_bytes(8, 768, r) == fixed + 2 * stage == 21_760
    assert lora_binding.decode_smem_bytes(8, 18432, 768, r) == fixed + 6 * stage == 58_624
    stage16 = 64 * 16 * 2 + 64 * 128 * 2
    fixed16 = 1024 + 16 * 128 * 4 + 256
    assert lora_binding.decode_smem_bytes(16, 4096, 14336, r) == fixed16 + 5 * stage16
    assert 2 * (fixed16 + 6 * stage16 + 1024) > 233_472
    for M in (1, 8, 9, 16):
        for N in (768, 4608, 22528):
            assert 2 * (lora_binding.decode_smem_bytes(M, 200_000, N, r) + 1024) <= 233_472
        assert 2 * (lora_binding.decode_u_smem_bytes(M, 200_000, r) + 1024) <= 233_472


def _lora_shapes(arch):
    """(K, N) of each adapted projection of one layer of ``arch``."""
    cfg = get_arch(arch)
    D, F = cfg.d_model, cfg.d_ff
    if cfg.layer_pattern == "M":  # in_proj, out_proj
        d_inner, H, P, N, _ = mamba2.dims(cfg)
        return [(D, 2 * d_inner + 2 * N + H), (d_inner, D)]
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    mlp = [(D, F)] * (1 if cfg.mlp_activation == "gelu" else 2) + [(F, D)]
    return [(D, q), (D, kv), (q, D)] + mlp


@pytest.mark.parametrize("arch", ["fedsllm-100m", "mamba2-130m", "phi4-mini-3.8b",
                                  "starcoder2-7b", "command-r-35b", "gemma2-9b"])
def test_lora_rule_sends_no_served_decode_shape_to_generic(arch):
    """Every LoRA product of a decode step of the six served configs (M =
    batch 1-16, the configs' rank and a rank of 128) takes the decode
    variant, the large-K down projections of starcoder2-7b (K=18432) and
    command-r-35b (K=22528) included."""
    for r in ((get_arch(arch).lora or LoRAConfig()).rank, 128):
        for K, N in _lora_shapes(arch):
            for M in (1, 2, 8, 16):
                assert lora_binding.variant(M, K, N, r, True) == "decode", (M, K, N, r)


S_ = 512  # the sequence length in the strides below


@pytest.mark.parametrize("d,strides,pointers,expected", [
    (64, [S_ * 12 * 64, 64, 12 * 64] * 3, [0, 4096, 8192], "wgmma"),  # the model's layout
    (64, [512 * 64 * 12, 512 * 64, 64] * 3, [256] * 3, "wgmma"),  # contiguous (B, H, S, d)
    (64, [S_ * 12 * 64, 64, 12 * 64] * 3, [2, 4096, 8192], "wmma"),  # q 2 bytes off
    (64, [100 * 4 * 64 + 1, 64, 4 * 64] + [S_ * 12 * 64, 64, 12 * 64] * 2, [0] * 3, "wmma"),
    (64, [0, 64, 12 * 64] * 3, [0] * 3, "wmma"),  # a broadcast batch
    (16, [S_ * 4 * 16, 16, 4 * 16] * 3, [0] * 3, "wmma"),
    (32, [S_ * 4 * 32, 32, 4 * 32] * 3, [0] * 3, "wmma"),
    (128, [S_ * 4 * 128, 128, 4 * 128] * 3, [0] * 3, "wgmma"),  # phi4, starcoder2, command-r
    (128, [S_ * 4 * 128, 128, 4 * 128] * 3, [0, 0, 8], "wmma"),  # v 8 bytes off
    (256, [S_ * 16 * 256, 256, 16 * 256] * 3, [0] * 3, "wgmma"),  # gemma2's prefill
    (256, [S_ * 16 * 256, 256, 16 * 256] * 3, [2, 0, 0], "wmma"),  # misaligned
])
def test_flash_variant_rule(d, strides, pointers, expected):
    """Head dims 64, 128 and 256 with TMA-aligned strides and pointers take
    the wgmma variant; everything else the first port's wmma kernel."""
    assert flash_binding.variant(d, strides, pointers) == expected


@pytest.mark.parametrize("d", flash_binding.HEAD_DIMS)
def test_flash_variant_rule_fp32(d):
    """fp32 inputs take the fp32 variant at every compiled head dim, 256
    (gemma2's) included, whatever the strides."""
    assert 256 in flash_binding.HEAD_DIMS
    assert flash_binding.variant(d, [S_ * 4 * d, d, 4 * d] * 3, [0] * 3, fp32=True) == "fp32"
    assert flash_binding.variant(d, [1] * 9, [2] * 3, fp32=True) == "fp32"


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

# test_kernels.py's ATTN_CASES (B, H, Kv, S, d, window, softcap, dtype) plus
# ragged lengths, which the reference wrapper pads and the port masks
ATTN_CASES = [
    (2, 4, 2, 128, 64, 0, 0.0, "float32"),
    (1, 4, 4, 256, 32, 64, 0.0, "float32"),  # sliding window
    (1, 2, 1, 128, 64, 0, 50.0, "float32"),  # softcap + MQA
    (1, 8, 2, 192, 64, 0, 0.0, "bfloat16"),  # GQA bf16
    (2, 2, 2, 64, 128, 32, 30.0, "float32"),  # window + softcap
    (2, 6, 2, 100, 32, 0, 0.0, "float32"),  # ragged S, GQA
    (1, 4, 2, 77, 64, 20, 0.0, "float32"),  # ragged S + window
    (1, 2, 1, 128, 256, 64, 50.0, "float32"),  # gemma2's head dim, window and softcap
]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _attn_inputs(B, H, Kv, S, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, d), np.float32),
            rng.standard_normal((B, Kv, S, d), np.float32),
            rng.standard_normal((B, Kv, S, d), np.float32))


@pytest.mark.parametrize("B,H,Kv,S,d,window,softcap,dtype", ATTN_CASES)
def test_flash_plain_matches_pallas_and_ref(B, H, Kv, S, d, window, softcap, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(t, dtype) for t in _attn_inputs(B, H, Kv, S, d))
    o = flash_attention(tq, tk, tv, window=window, softcap=softcap)
    assert o.dtype == TORCH[dtype] and o.shape == (B, H, S, d)
    tol = ATTN_TOL[dtype]
    pallas = _np(jax_flash_attention(jq, jk, jv, window=window, softcap=softcap, bq=64, bk=64))
    ref = _np(jax_flash_attention_ref(jq, jk, jv, window=window, softcap=softcap))
    # on a failure, name all three distances, so that it shows which side moved
    msg = (f"max|plain - pallas| = {np.abs(_np(o) - pallas).max():.3e}, "
           f"max|plain - ref| = {np.abs(_np(o) - ref).max():.3e}, "
           f"max|pallas - ref| = {np.abs(pallas - ref).max():.3e}")
    for want in (pallas, ref):
        np.testing.assert_allclose(_np(o), want, rtol=tol, atol=tol, err_msg=msg)


@pytest.mark.parametrize("B,H,Kv,S,d,window,softcap,dtype",
                         [c for c in ATTN_CASES if c[-1] == "float32"])
def test_flash_plain_matches_attend_full_in_model_layout(B, H, Kv, S, d, window, softcap, dtype):
    """The port's model-layout call (the flash path of layers.attention) and
    its _attend_full baseline against the reference's _attend_full."""
    q, k, v = (np.ascontiguousarray(t.transpose(0, 2, 1, 3)) for t in _attn_inputs(B, H, Kv, S, d))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(t, dtype) for t in (q, k, v))
    ref = jax_layers._attend_full(jq, jk, jv, causal=True, window=window, softcap=softcap)
    for attend in (torch_layers._attend_flash, torch_layers._attend_full):
        out = attend(tq, tk, tv, causal=True, window=window, softcap=softcap)
        assert out.shape == (B, S, H * d)
        np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)


# (B, H, Kv, Sq, Skv, d, causal, window, softcap): head dims 16, 64 and 256,
# causal with a window and a softcap, non-causal with Skv != Sq (the Pallas
# kernel unpadded: Skv a multiple of its key block)
TF32X3_CASES = [
    (2, 4, 2, 160, 160, 16, True, 0, 0.0),
    (1, 2, 1, 128, 128, 64, True, 32, 30.0),
    (1, 2, 1, 96, 96, 256, True, 0, 50.0),
    (1, 4, 2, 64, 128, 64, False, 0, 0.0),
]


def _pallas_fp32(q, k, v, causal, window, softcap):
    """The reference's Pallas kernel in interpret mode, 64-row blocks, as
    test_flash_plain_matches_pallas_and_ref runs it (its wrapper pads a
    causal S; a non-causal Sq != Skv goes to the kernel itself)."""
    args = [jnp.asarray(t) for t in (q, k, v)]
    if causal:
        return _np(jax_flash_attention(*args, window=window, softcap=softcap, bq=64, bk=64))
    return _np(jax_flash_attention_pallas(*args, causal=False, window=window, softcap=softcap,
                                          bq=64, bk=64, interpret=True))


@pytest.mark.parametrize("B,H,Kv,Sq,Skv,d,causal,window,softcap", TF32X3_CASES)
def test_flash_tf32x3_ref_matches_pallas(B, H, Kv, Sq, Skv, d, causal, window, softcap):
    """The fp32 variant's arithmetic (TF32 big and small terms, three
    products, 64-key tiles each summed from zero, the online softmax) within
    the reference's fp32 limit, 2e-5 + 2e-5·|o| per element, of the Pallas
    kernel in interpret mode."""
    rng = np.random.default_rng(Sq + d)
    q = rng.standard_normal((B, H, Sq, d), np.float32)
    k, v = (rng.standard_normal((B, Kv, Skv, d), np.float32) for _ in range(2))
    o = flash_attention_tf32x3_ref(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal,
                                   window=window, softcap=softcap)
    assert o.dtype == torch.float32 and o.shape == (B, H, Sq, d)
    np.testing.assert_allclose(_np(o), _pallas_fp32(q, k, v, causal, window, softcap),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dropped", [None, "q", "k", "p", "v"])
def test_flash_tf32x3_needs_each_small_term(dropped):
    """The precision argument of the fp32 variant: with the small terms of
    Q, K, P and V the three products are within 2e-5 + 2e-5·|o| of the
    Pallas kernel; without any one of them (its product, small·big, left
    out) they are not."""
    B, H, Kv, Sq, Skv, d, causal, window, softcap = TF32X3_CASES[1]
    rng = np.random.default_rng(Sq + d)
    q = rng.standard_normal((B, H, Sq, d), np.float32)
    k, v = (rng.standard_normal((B, Kv, Skv, d), np.float32) for _ in range(2))
    want = _pallas_fp32(q, k, v, causal, window, softcap)
    terms = tuple(t for t in attn_ref.TF32_TERMS if t != dropped)
    o = _np(flash_attention_tf32x3_ref(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal,
                                       window=window, softcap=softcap, terms=terms))
    excess = (np.abs(o - want) - 2e-5 * np.abs(want)).max()
    assert (excess <= 2e-5) == (dropped is None), excess


def test_tf32_rounds_to_nearest_ties_away():
    """The mirror's TF32 rounding, the kernel's: 10 mantissa bits, to
    nearest, ties away from zero, on the fp32 bits; v = big + small within
    small's own rounding."""
    one = 1.0
    cases = {one + 2 ** -11: one + 2 ** -10, -(one + 2 ** -11): -(one + 2 ** -10),  # ties
             one + 2 ** -12: one, one + 3 * 2 ** -12: one + 2 ** -10, 3.0: 3.0, 0.0: 0.0}
    x = torch.tensor(list(cases), dtype=torch.float32)
    assert attn_ref.tf32(x).tolist() == list(cases.values())
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    big, small = attn_ref.split_tf32(v)
    assert (((big.view(torch.int32) | small.view(torch.int32)) & 0x1FFF) == 0).all()
    assert ((v - big - small).abs() <= 2.0 ** -21 * v.abs()).all()


def test_flash_plain_non_causal_ragged_kv():
    """Sq != Skv without causal masking: the reference wrapper gives up on the
    kernel here (attn_ops.py:27-31); the port's plain version follows its ref."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 40, 32), np.float32)
    k = rng.standard_normal((1, 2, 72, 32), np.float32)
    v = rng.standard_normal((1, 2, 72, 32), np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(t, "float32") for t in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=False)
    ref = jax_flash_attention_ref(jq, jk, jv, causal=False)
    np.testing.assert_allclose(_np(o), _np(ref), rtol=2e-5, atol=2e-5)


def test_flash_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(t) for t in _attn_inputs(1, 4, 2, 16, 32))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :8], v)  # k/v shapes differ
    with pytest.raises(ValueError):
        flash_attention(q[:, :3], k, v)  # 3 heads over 2 kv heads
    with pytest.raises(TypeError):
        flash_attention(q, k.double(), v.double())
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3), k, v)  # head dim not contiguous
