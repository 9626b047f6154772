"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA GPU and skips without one: a CUDA kernel has no
CPU mode. This file imports neither ``jax`` nor ``repro``, so it also runs on
a machine with the card and without JAX; there the repository's
``conftest.py`` (which imports JAX) is skipped:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.config import FedsLLMConfig, get_arch, smoke_variant
from repro_torch.core import fedsllm, split
from repro_torch.core.lora import init_lora, merge
from repro_torch.data.tokens import TokenStream, client_batches
from repro_torch.kernels.attn_ops import flash_attention
from repro_torch.kernels.attn_ref import flash_attention_fp32, flash_attention_ref
from repro_torch.kernels.lora_ops import lora_matmul
from repro_torch.kernels.lora_ref import lora_matmul_ref
from repro_torch.kernels.ssd_ops import ssd_scan
from repro_torch.kernels.ssd_ref import ssd_scan_ref
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map, tree_rel_gap

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16_ulps(ref, n=2.0):
    """n bf16 ulps of the largest output: the kernel and the plain version
    round the same fp32 sums, accumulated in another order."""
    return n * 2.0 ** -7 * ref.float().abs().max().item()


@pytest.mark.parametrize("M,K,N,r", [
    (8, 768, 768, 16), (37, 768, 256, 16), (4096, 768, 2048, 16), (8, 2048, 768, 16),
    (5, 64, 64, 16),  # smoke widths: K below one K tile, r above it
    (100, 200, 300, 8), (32, 1024, 64, 32), (70, 96, 130, 64), (3, 40, 24, 5),
])
def test_lora_kernel_matches_plain(cuda, M, K, N, r):
    gen = torch.Generator(device=cuda).manual_seed(M * 7 + N)
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    w, a, b = (torch.randn(s, generator=gen, device=cuda).mul(0.05).bfloat16()
               for s in ((K, N), (K, r), (r, N)))
    before = lora_matmul.launches
    y = lora_matmul(x, w, a, b, scale=2.0)
    torch.cuda.synchronize()
    assert lora_matmul.launches == before + 1
    ref = lora_matmul_ref(x, w, a, b, scale=2.0)
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= _bf16_ulps(ref), (err, _bf16_ulps(ref))


@pytest.mark.parametrize("M,K,N,r,expected", [
    # M around the decode/prefill threshold (16)
    (1, 768, 768, 16, "decode"), (8, 768, 768, 16, "decode"), (16, 768, 768, 16, "decode"),
    (17, 768, 768, 16, "prefill"), (4096, 768, 768, 16, "prefill"),
    # N not a multiple of the tile; 300 is not a multiple of 8 either
    (8, 768, 3352, 16, "decode"), (4096, 768, 3352, 16, "prefill"),
    (8, 768, 300, 16, "decode"), (300, 768, 300, 16, "prefill"),  # W, B, y copied
    # K not a multiple of the stage depth (64 for prefill, 8 x 32 for decode)
    (8, 776, 256, 16, "decode"), (1000, 776, 256, 16, "prefill"), (13, 40, 64, 16, "decode"),
    (4096, 2048, 768, 16, "prefill"), (8, 2048, 768, 16, "decode"),
    # ranks (1: A's rows 2 bytes apart, copied by the producer warps)
    (8, 768, 768, 1, "decode"), (4096, 768, 768, 1, "prefill"),
    (8, 768, 768, 8, "decode"), (512, 768, 768, 8, "prefill"),
    (8, 768, 768, 64, "decode"), (512, 768, 768, 64, "prefill"),
    (4096, 768, 2048, 64, "prefill"), (200, 768, 2048, 32, "prefill"),
    # the down projections of starcoder2-7b and command-r-35b at decode
    *[(M, K, N, 16, "decode") for K, N in ((18432, 4608), (22528, 8192)) for M in (1, 2, 8, 16)],
])
def test_lora_variants_at_their_edges(cuda, M, K, N, r, expected):
    """Each variant against the plain version around its edges; the wrapper's
    per-variant counter shows which one ran."""
    gen = torch.Generator(device=cuda).manual_seed(M + 3 * N + r)
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    w, a, b = (torch.randn(s, generator=gen, device=cuda).mul(0.05).bfloat16()
               for s in ((K, N), (K, r), (r, N)))
    before = dict(lora_matmul.variant_launches)
    y = lora_matmul(x, w, a, b, scale=2.0)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in lora_matmul.variant_launches.items()}
    assert moved == {k: int(k == expected) for k in moved}, moved
    ref = lora_matmul_ref(x, w, a, b, scale=2.0)
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= _bf16_ulps(ref), (err, _bf16_ulps(ref))


@pytest.mark.parametrize("K,N", [(2048, 768), (18432, 4608)])  # clusters of 8 and 7 blocks
def test_lora_decode_is_deterministic(cuda, K, N):
    """The decode variant adds the cluster's partials in a fixed order: the
    same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((8, K), generator=gen, device=cuda).bfloat16()
    w, a, b = (torch.randn(s, generator=gen, device=cuda).mul(0.05).bfloat16()
               for s in ((K, N), (K, 16), (16, N)))
    first = lora_matmul(x, w, a, b, scale=2.0)
    for _ in range(3):
        assert torch.equal(lora_matmul(x, w, a, b, scale=2.0), first)


def test_lora_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, w, a, b = (torch.randn(s, device=cuda) for s in ((8, 64), (64, 32), (64, 4), (4, 32)))
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            lora_matmul(*(t.to(dtype) for t in (x, w, a, b)))
    with pytest.raises(TypeError):
        lora_matmul(x, w.bfloat16(), a, b)  # mixed dtypes


@pytest.fixture
def no_tf32():
    """fp32 products of the plain versions in full fp32 (TF32 would be the
    side that is off at these limits)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("M,K,N,r,dtype,expected", [
    # fp32: the smoke widths, fedsllm-100m's widths at prefill and decode,
    # ragged shapes, ranks that are not a multiple of 4 or 8
    (5, 64, 64, 16, F32, "fp32"), (32, 64, 128, 16, F32, "fp32"),
    (4096, 768, 2048, 16, F32, "fp32"), (4096, 2048, 768, 16, F32, "fp32"),
    (8, 768, 256, 16, F32, "fp32"), (8, 2048, 768, 16, F32, "fp32"),
    (100, 200, 300, 8, F32, "fp32"), (3, 40, 24, 5, F32, "fp32"), (130, 96, 130, 33, F32, "fp32"),
    # ranks above 64: bf16 through prefill and decode (two launches; at N =
    # 130 W's, B's and the output's rows copied); fp32 through fp32's
    (64, 768, 768, 80, BF16, "prefill"), (4096, 768, 2048, 128, BF16, "prefill"),
    (8, 768, 768, 128, BF16, "decode"), (37, 96, 130, 100, BF16, "prefill"),
    (64, 768, 768, 80, F32, "fp32"), (4096, 768, 768, 128, F32, "fp32"),
    (8, 768, 768, 200, F32, "fp32"), (37, 96, 130, 100, F32, "fp32"),
])
def test_lora_fp32_and_high_ranks_match_plain(cuda, no_tf32, M, K, N, r, dtype, expected):
    """What the wrapper refused before: fp32 inputs and ranks above 64. Limits:
    1e-5 of the largest output in fp32 (the reference's fp32 tolerance, both
    sides full fp32 sums in another order), two bf16 ulps in bf16."""
    gen = torch.Generator(device=cuda).manual_seed(M + 5 * N + r)
    x = torch.randn((M, K), generator=gen, device=cuda).to(dtype)
    w, a, b = (torch.randn(s, generator=gen, device=cuda).mul(0.05).to(dtype)
               for s in ((K, N), (K, r), (r, N)))
    before = dict(lora_matmul.variant_launches)
    y = lora_matmul(x, w, a, b, scale=2.0)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in lora_matmul.variant_launches.items()}
    assert moved == {k: int(k == expected) for k in moved}, moved
    assert y.dtype == dtype
    ref = lora_matmul_ref(x, w, a, b, scale=2.0)
    err = (y.float() - ref.float()).abs().max().item()
    tol = 1e-5 * ref.abs().max().item() if dtype == F32 else _bf16_ulps(ref)
    assert err <= tol, (err, tol)


def _lora_bf16(cuda, M, K, N, r, seed, offset=0):
    """Seeded bf16 operands; ``offset`` elements shift x off a 16-byte boundary."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    if offset:
        x = torch.empty(M * K + offset, dtype=x.dtype, device=cuda)[offset:].view(M, K).copy_(x)
    w, a, b = (torch.randn(s, generator=gen, device=cuda).mul(0.05).bfloat16()
               for s in ((K, N), (K, r), (r, N)))
    return x, w, a, b


def _held(x, w, a, b, expected):
    """One wrapper call: the variant that ran, and the error against the plain
    version within 2 bf16 ulps of its largest output."""
    before = dict(lora_matmul.variant_launches)
    y = lora_matmul(x, w, a, b, scale=2.0)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in lora_matmul.variant_launches.items()}
    assert moved == {k: int(k == expected) for k in moved}, moved
    ref = lora_matmul_ref(x, w, a, b, scale=2.0)
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= _bf16_ulps(ref), (err, _bf16_ulps(ref))
    return y


@pytest.mark.parametrize("r", [72, 128, 256])
@pytest.mark.parametrize("M", [4096, 300, 16, 8])
@pytest.mark.parametrize("K,N", [(768, 256), (768, 2048), (4096, 14336)])
def test_lora_ranks_72_to_256_take_prefill_and_decode(cuda, M, K, N, r):
    """Ranks 72-256 (multiples of 8, aligned) run the Hopper variants in two
    launches, prefill above 16 rows (ragged M = 300 too) and decode at 16 and
    below, each within 2 bf16 ulps of the largest output of the plain
    version."""
    _held(*_lora_bf16(cuda, M, K, N, r, seed=M + N + r), "prefill" if M > 16 else "decode")


@pytest.mark.parametrize("K,N", [(768, 768), (4096, 14336)])
def test_lora_decode_is_deterministic_at_rank_256(cuda, K, N):
    """Both decode launches at 256 ranks add their clusters' partials in a
    fixed order: the same inputs give the same bits."""
    x, w, a, b = _lora_bf16(cuda, 8, K, N, 256, seed=13)
    first = _held(x, w, a, b, "decode")
    for _ in range(3):
        assert torch.equal(lora_matmul(x, w, a, b, scale=2.0), first)


@pytest.mark.parametrize("M,K,N,r,shifted", [
    (4096, 768, 2048, 128, "x"), (8, 768, 768, 128, "x"),  # x one element off 16 bytes
    (4096, 768, 2048, 16, "x"), (8, 768, 768, 16, "x"), (300, 776, 256, 5, "x"),
    (8, 772, 768, 16, None), (300, 772, 256, 100, None),  # K not a multiple of 8
    (4096, 772, 2048, 16, None), (8, 768, 300, 16, None), (4096, 768, 300, 16, None),  # N % 8
    (8, 768, 300, 100, None), (37, 40, 24, 5, None),
    (4096, 768, 2048, 16, "w"), (8, 768, 768, 16, "w"), (8, 2048, 768, 128, "w"),  # W off
    (4096, 768, 2048, 16, "b"), (8, 768, 768, 100, "b"),  # B off
    (4096, 768, 2048, 16, "a"), (8, 768, 768, 16, "a"),  # A off (A's tiles copied alone)
    (4096, 768, 2048, 16, "y"), (8, 768, 768, 16, "y"), (300, 768, 256, 128, "y"),  # y off
])
def test_lora_generic_keeps_misaligned_and_odd_ranks(cuda, M, K, N, r, shifted):
    """What TMA cannot read (a pointer one element off 16 bytes, rows of K
    or N elements not 16-byte strided), the first port's kernel's shapes,
    runs on prefill and decode: the producers copy the tiles TMA cannot map
    and an output TMA cannot write takes plain stores; within 2 bf16 ulps
    of the largest output of the plain version."""
    from repro_torch.kernels import lora_matmul as binding

    ops = dict(zip("xwab", _lora_bf16(cuda, M, K, N, r, seed=M + r + K)))
    if shifted in ops:  # the operand's values one element into a buffer
        t = ops[shifted]
        ops[shifted] = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:].view_as(
            t).copy_(t)
    expected = "prefill" if M > 16 else "decode"
    if shifted != "y":
        _held(*ops.values(), expected)
        return
    out = torch.empty(M * N + 1, dtype=torch.bfloat16, device=cuda)[1:].view(M, N)
    kind, extra = binding.plan(M, K, N, r, True)
    assert kind == expected
    binding.lora_matmul_cuda(*ops.values(), 2.0, kind, extra, out=out)
    torch.cuda.synchronize()
    ref = lora_matmul_ref(*ops.values(), scale=2.0)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _bf16_ulps(ref), (err, _bf16_ulps(ref))


@pytest.mark.parametrize("M,K,N,r", [
    (4096, 768, 2048, 100), (8, 768, 768, 100),  # r not a multiple of 8 (once on generic)
    (300, 768, 256, 264), (8, 768, 256, 264),  # r above 256 (once on generic)
    *[(M, 768, 2048 if M > 16 else 768, r) for r in (1, 4, 7, 100, 264, 512)
      for M in (8, 37, 4096)],
    (1000, 776, 256, 5), (8, 776, 256, 5),  # K not a multiple of a ring step
    (16, 18432, 4608, 7), (13, 4096, 14336, 33),  # long K, 128-column slices
    (300, 4096, 14336, 100), (16, 2048, 768, 1023),
])
def test_lora_any_aligned_rank_takes_prefill_and_decode(cuda, M, K, N, r):
    """Every rank at TMA-readable K, N and pointers runs the Hopper variants:
    ranks that are not a multiple of 8 with A's tiles copied by the producer
    warps, ranks above 64 in two launches with u's scratch padded to a
    multiple of 8 ranks; each within 2 bf16 ulps of the largest output of the
    plain version."""
    _held(*_lora_bf16(cuda, M, K, N, r, seed=M + N + r), "prefill" if M > 16 else "decode")


@pytest.mark.parametrize("M,K,N,r", [
    (4096, 768, 2048, 16), (300, 776, 256, 64), (4096, 768, 2048, 128),
    (8, 768, 768, 16), (16, 2048, 768, 64), (8, 768, 768, 128), (12, 4096, 14336, 16),
])
def test_lora_copied_a_matches_the_tensor_map_at_aligned_ranks(cuda, M, K, N, r):
    """The producer warps' copy of A (its placement in the 32- and 128-byte
    swizzled tiles the wgmma descriptors read) at ranks TMA also reads: the
    same result within 2 bf16 ulps of the plain version."""
    from repro_torch.kernels import lora_matmul as binding

    x, w, a, b = _lora_bf16(cuda, M, K, N, r, seed=M + r)
    kind, extra = binding.plan(M, K, N, r, True)
    assert extra[-1] == 0
    y = binding.lora_matmul_cuda(x, w, a, b, 2.0, kind, extra[:-1] + (1,))
    torch.cuda.synchronize()
    ref = lora_matmul_ref(x, w, a, b, scale=2.0)
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= _bf16_ulps(ref), (err, _bf16_ulps(ref))


def _lora_f32(cuda, M, K, N, r, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=cuda)
    w, a, b = (torch.randn(s, generator=gen, device=cuda).mul(0.05)
               for s in ((K, N), (K, r), (r, N)))
    return x, w, a, b


@pytest.mark.parametrize("M", [1, 2, 8, 16])
@pytest.mark.parametrize("K,N,r", [
    (768, 768, 16), (2048, 768, 16), (768, 300, 16), (777, 301, 5), (14336, 300, 33),
    (3584, 299, 64), (768, 768, 80), (2048, 301, 128),
])
def test_lora_fp32_decode_matches_plain(cuda, no_tf32, M, K, N, r):
    """The fp32 decode design (clusters splitting K, a cp.async ring, CUDA-core
    FMAs; above 64 ranks u in a launch of its own) within 1e-5 of the
    largest output of the plain version, N = 300 and odd widths included."""
    x, w, a, b = _lora_f32(cuda, M, K, N, r, seed=M + K + N + r)
    before = dict(lora_matmul.variant_launches)
    y = lora_matmul(x, w, a, b, scale=2.0)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in lora_matmul.variant_launches.items()}
    assert moved == {k: int(k == "fp32") for k in moved}, moved
    ref = lora_matmul_ref(x, w, a, b, scale=2.0)
    err = (y - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.parametrize("M,K,N,r", [(8, 2048, 768, 16), (2, 14336, 3584, 16),
                                     (16, 768, 768, 128)])
def test_lora_fp32_decode_is_deterministic(cuda, no_tf32, M, K, N, r):
    """The fp32 decode design adds the warps' and the cluster's partials in a
    fixed order: the same inputs give the same bits."""
    x, w, a, b = _lora_f32(cuda, M, K, N, r, seed=3)
    first = lora_matmul(x, w, a, b, scale=2.0)
    for _ in range(3):
        assert torch.equal(lora_matmul(x, w, a, b, scale=2.0), first)


@pytest.mark.parametrize("M,K,N,r", [
    (8, 768, 768, 16), (2, 14336, 3584, 16), (16, 777, 300, 33), (4, 64, 64, 16),
    (8, 2048, 768, 128), (3, 3584, 1024, 5),
])
def test_lora_fp32_decode_reads_w_by_tma_or_cp_async(cuda, no_tf32, M, K, N, r):
    """The fp32 decode design's two ways of reading W (A in the u launch
    above 64 ranks), TMA and cp.async, give the same bits, within 1e-5 of
    the largest output of the plain version."""
    from repro_torch.kernels import lora_matmul as binding

    x, w, a, b = _lora_f32(cuda, M, K, N, r, seed=M + K + r)
    split, usplit, _, _, two = binding.plan(M, K, N, r, True, True)[1]
    ys = [binding.lora_matmul_cuda(x, w, a, b, 2.0, "fp32", (split, usplit, 0, tma, two))
          for tma in (0, 1)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1])
    ref = lora_matmul_ref(x, w, a, b, scale=2.0)
    err = (ys[1] - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.parametrize("bn", [128, 64])
@pytest.mark.parametrize("M,K,N,r", [
    (4096, 768, 2048, 16), (4096, 4096, 1024, 16), (1000, 2048, 768, 128), (300, 777, 301, 33),
    (130, 96, 130, 5), (4096, 768, 2048, 80),
])
def test_lora_fp32_prefill_in_two_launches_matches_plain(cuda, no_tf32, M, K, N, r, bn):
    """The fp32 prefill's two launches (u = scale·x·A, then [x | scale·u]·[W;
    B] in 3xTF32 on the tensor cores, each stage's sum added in fp32) within
    1e-5 of the largest output of the plain version, up to K = 4096."""
    from repro_torch.kernels import lora_matmul as binding

    x, w, a, b = _lora_f32(cuda, M, K, N, r, seed=M + r)
    y = binding.lora_matmul_cuda(x, w, a, b, 2.0, "fp32", (0, 0, bn, 0, 1))
    torch.cuda.synchronize()
    ref = lora_matmul_ref(x, w, a, b, scale=2.0)
    err = (y - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.parametrize("B,H,Kv,Sq,Skv,d,causal,window,softcap", [
    (2, 4, 2, 16, 16, 16, True, 0, 0.0),  # the smoke prefill
    (2, 4, 2, 100, 100, 16, True, 0, 0.0),
    (1, 4, 4, 256, 256, 32, True, 64, 0.0),  # window
    (8, 12, 4, 512, 512, 64, True, 0, 0.0),  # fedsllm-100m's prefill
    (2, 12, 4, 512, 512, 64, True, 128, 0.0),
    (1, 2, 1, 128, 128, 64, True, 0, 50.0),  # softcap, MQA
    (2, 12, 4, 200, 200, 64, True, 100, 50.0),  # ragged, window and softcap
    (2, 4, 1, 70, 130, 128, False, 0, 0.0),  # non-causal, Skv != Sq
    (2, 2, 2, 300, 300, 128, True, 32, 30.0),
    (1, 4, 2, 512, 512, 256, True, 0, 50.0),  # gemma2's head dim and softcap
    (2, 4, 2, 300, 300, 256, True, 64, 50.0),  # ragged, window
    (1, 2, 1, 70, 130, 256, False, 0, 0.0),
    (2, 4, 2, 130, 130, 16, True, 32, 30.0),  # head dims 16 and 32: window, softcap, ragged
    (1, 4, 1, 200, 200, 32, True, 0, 0.0),
    (1, 4, 2, 32, 4096, 64, False, 0, 0.0),  # a long Skv: O summed over 64 key tiles
    (1, 4, 2, 4096, 4096, 128, True, 0, 0.0),
    (1, 2, 1, 4160, 4160, 256, True, 0, 50.0),
])
@pytest.mark.parametrize("layout", ["model", "misaligned", "strided"])
def test_flash_fp32_matches_plain(cuda, no_tf32, B, H, Kv, Sq, Skv, d, causal, window, softcap,
                                  layout):
    """The fp32 variant (3xTF32 on wgmma) at the reference's fp32
    tolerance, 2e-5 + 2e-5·|o| per element (tests/test_kernels.py): both
    keep P in fp32. Views in the model's (B, S, heads, d) layout; q one
    element off 16 bytes (4-byte loads); k and v rows of a wider buffer,
    strides not a multiple of 4."""
    gen = torch.Generator(device=cuda).manual_seed(Sq * 5 + d)
    q = torch.randn((B, Sq, H, d), generator=gen, device=cuda).transpose(1, 2)
    k, v = (torch.randn((B, Skv, Kv, d), generator=gen, device=cuda).transpose(1, 2)
            for _ in range(2))
    if layout == "misaligned":
        q = torch.empty(q.numel() + 1, device=cuda)[1:].view(B, Sq, H, d).copy_(
            q.transpose(1, 2)).transpose(1, 2)
    if layout == "strided":  # rows Kv·d + 1 apart
        k, v = (torch.zeros((B, Skv, Kv * d + 1), device=cuda)[..., :Kv * d].unflatten(
            -1, (Kv, d)).copy_(t.transpose(1, 2)).transpose(1, 2) for t in (k, v))
        assert k.stride(2) % 4 != 0
    before = dict(flash_attention.variant_launches)
    o = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    moved = {k_: v_ - before[k_] for k_, v_ in flash_attention.variant_launches.items()}
    assert moved == {k_: int(k_ == "fp32") for k_ in moved}, moved
    assert o.dtype == torch.float32
    ref = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    excess = ((o - ref).abs() - 2e-5 * ref.abs()).max().item()
    assert excess <= 2e-5, excess


@pytest.mark.parametrize("arch,variants", [
    ("fedsllm-100m", {"lora_matmul": "fp32", "flash_attention": "fp32"}),
    ("mamba2-130m", {"lora_matmul": "fp32", "ssd_scan": "fma"}),
])
def test_fp32_smoke_serving_runs_the_fp32_variants(cuda, no_tf32, arch, variants):
    """Prefill + one decode step of the fp32 smoke model, as ``launch.serve
    --smoke`` runs it: every launch on the fp32 (or SSD ``fma``) variant,
    logits within 1e-4 of the plain path's largest."""
    cfg = smoke_variant(get_arch(arch))
    params = T.init_params(cfg, seed=0, device=cuda)
    lora = init_lora(params, cfg, seed=1, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    for ab in lora.values():
        ab["B"] = torch.randn(ab["B"].shape, generator=gen, device=cuda) * 0.05
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen, device=cuda)
    kernels = {"lora_matmul": lora_matmul, "flash_attention": flash_attention,
               "ssd_scan": ssd_scan}
    before = {n: dict(fn.variant_launches) for n, fn in kernels.items()}
    cache = T.init_cache(cfg, 2, 48, device=cuda)
    logits, cache = T.prefill(params, {"tokens": tokens}, cfg, cache, lora=lora)
    step, cache = T.decode_step(params, tokens[:, -1:], cache, 40, cfg, lora=lora)
    torch.cuda.synchronize()
    for name, fn in kernels.items():
        moved = {k: v - before[name][k] for k, v in fn.variant_launches.items()}
        assert all(n == 0 or k == variants.get(name) for k, n in moved.items()), (name, moved)
        assert (sum(moved.values()) > 0) == (name in variants), (name, moved)
    merged = merge(params, lora, cfg)
    plain_cache = T.init_cache(cfg, 2, 48, device=cuda)
    ref, plain_cache = T.prefill(merged, {"tokens": tokens}, cfg, plain_cache, kernels=False)
    ref_step, _ = T.decode_step(merged, tokens[:, -1:], plain_cache, 40, cfg)
    for got, want in ((logits, ref), (step, ref_step)):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (err, want.abs().max().item())


@pytest.mark.parametrize("B,H,Kv,Sq,Skv,d,causal,window,softcap", [
    (8, 12, 4, 512, 512, 64, True, 0, 0.0),
    (8, 12, 4, 200, 200, 64, True, 0, 0.0),  # ragged
    (2, 12, 4, 512, 512, 64, True, 128, 0.0),  # window
    (2, 12, 4, 512, 512, 64, True, 0, 50.0),  # softcap
    (1, 4, 2, 100, 100, 32, True, 20, 30.0),
    (2, 4, 2, 16, 16, 16, True, 0, 0.0),  # smoke widths
    (2, 4, 1, 70, 130, 128, False, 0, 0.0),  # non-causal, ragged Skv != Sq
])
def test_flash_kernel_matches_plain(cuda, B, H, Kv, Sq, Skv, d, causal, window, softcap):
    gen = torch.Generator(device=cuda).manual_seed(Sq + d)
    # the model's (B, S, heads, d) layout, handed over as transposed views
    q = torch.randn((B, Sq, H, d), generator=gen, device=cuda).bfloat16().transpose(1, 2)
    k, v = (torch.randn((B, Skv, Kv, d), generator=gen, device=cuda).bfloat16().transpose(1, 2)
            for _ in range(2))
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    # the kernel also rounds P to bf16 for P·V (2^-9 relative per weight,
    # below one output ulp; the plain version keeps P in fp32)
    err = (o.float() - ref.float()).abs().max().item()
    assert err <= _bf16_ulps(ref), (err, _bf16_ulps(ref))


@pytest.mark.parametrize("B,H,Kv,Sq,Skv,d,causal,window,softcap,expected", [
    (2, 12, 4, 1, 1, 64, True, 0, 0.0, "wgmma"),
    (2, 12, 4, 63, 63, 64, True, 0, 0.0, "wgmma"),
    (2, 12, 4, 65, 65, 64, True, 0, 0.0, "wgmma"),
    (8, 12, 4, 512, 512, 64, True, 0, 0.0, "wgmma"),
    (2, 12, 4, 512, 512, 64, True, 100, 30.0, "wgmma"),  # window and softcap together
    (2, 12, 4, 65, 65, 64, True, 16, 0.0, "wgmma"),
    (2, 12, 4, 100, 300, 64, False, 0, 0.0, "wgmma"),  # non-causal, Skv > Sq
    (2, 12, 4, 300, 100, 64, False, 0, 20.0, "wgmma"),  # non-causal, Skv < Sq
    (2, 12, 4, 1, 512, 64, False, 0, 0.0, "wgmma"),
    # whisper-base: the encoder (1,500 frames, 23 blocks of 64 and 28) and
    # the decoder's cross-attention (32 queries against the 1,500 frames)
    (8, 8, 8, 1500, 1500, 64, False, 0, 0.0, "wgmma"),
    (8, 8, 8, 32, 1500, 64, False, 0, 0.0, "wgmma"),
    # query heads per kv head: 1, 2, 4 and 12 (blocks of 1, 2, 4 and 4 heads)
    (2, 4, 4, 130, 130, 64, True, 0, 0.0, "wgmma"),
    (2, 8, 4, 130, 130, 64, True, 0, 0.0, "wgmma"),
    (2, 8, 2, 130, 130, 64, True, 0, 0.0, "wgmma"),
    (1, 12, 1, 200, 200, 64, True, 0, 0.0, "wgmma"),
    (2, 4, 2, 100, 100, 16, True, 0, 0.0, "wmma"),
    (2, 4, 2, 100, 100, 32, True, 0, 0.0, "wmma"),
    # head dim 128 (phi4-mini, starcoder2, command-r): their heads, GQA, MQA,
    # window and softcap, ragged
    (2, 4, 2, 100, 100, 128, True, 0, 0.0, "wgmma"),
    (1, 24, 8, 512, 512, 128, True, 0, 0.0, "wgmma"),
    (2, 12, 4, 129, 129, 128, True, 64, 50.0, "wgmma"),
    (2, 8, 1, 1, 1, 128, True, 0, 0.0, "wgmma"),
    (2, 8, 1, 300, 100, 128, False, 0, 20.0, "wgmma"),
    # gemma2's head dim: global and windowed layers with its softcap (window
    # 256 at a short S), ragged Sq != Skv, MQA and GQA
    (1, 16, 8, 1024, 1024, 256, True, 0, 50.0, "wgmma"),
    (1, 16, 8, 1024, 1024, 256, True, 256, 50.0, "wgmma"),
    (2, 4, 2, 300, 300, 256, True, 64, 0.0, "wgmma"),
    (2, 4, 1, 70, 130, 256, False, 0, 0.0, "wgmma"),
    (2, 16, 8, 300, 700, 256, True, 256, 50.0, "wgmma"),
    (2, 8, 1, 200, 333, 256, False, 0, 50.0, "wgmma"),
    (2, 16, 8, 1, 1, 256, True, 0, 50.0, "wgmma"),
    (2, 4, 4, 65, 65, 256, True, 16, 0.0, "wgmma"),
])
def test_flash_variants_at_their_edges(cuda, B, H, Kv, Sq, Skv, d, causal, window, softcap,
                                       expected):
    gen = torch.Generator(device=cuda).manual_seed(Sq * 3 + Skv + d)
    q = torch.randn((B, Sq, H, d), generator=gen, device=cuda).bfloat16().transpose(1, 2)
    k, v = (torch.randn((B, Skv, Kv, d), generator=gen, device=cuda).bfloat16().transpose(1, 2)
            for _ in range(2))
    before = dict(flash_attention.variant_launches)
    o = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    moved = {k_: v_ - before[k_] for k_, v_ in flash_attention.variant_launches.items()}
    assert moved == {k_: int(k_ == expected) for k_ in moved}, moved
    ref = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    err = (o.float() - ref.float()).abs().max().item()
    assert err <= _bf16_ulps(ref), (err, _bf16_ulps(ref))


@pytest.mark.parametrize("B,H,Kv,S,d,window", [
    (1, 16, 16, 1024, 128, 0),  # olmoe-1b-7b: MHA, group size 1
    (1, 64, 4, 1024, 128, 0),  # qwen3-moe-235b-a22b: a 16:1 GQA
    (1, 16, 1, 4096, 256, 2048),  # recurrentgemma-9b: MQA 16/1, window 2048
])
def test_flash_wgmma_at_the_moe_and_hybrid_heads(cuda, B, H, Kv, S, d, window):
    """The wgmma variant at the group sizes the MoE and hybrid configs serve
    (1, 16, and 16 over one kv head at d=256 with a window of 2048 on a
    prompt twice as long), against flash_attention_ref."""
    gen = torch.Generator(device=cuda).manual_seed(H * 7 + Kv + d)
    q = torch.randn((B, S, H, d), generator=gen, device=cuda).bfloat16().transpose(1, 2)
    k, v = (torch.randn((B, S, Kv, d), generator=gen, device=cuda).bfloat16().transpose(1, 2)
            for _ in range(2))
    before = dict(flash_attention.variant_launches)
    o = flash_attention(q, k, v, causal=True, window=window, softcap=0.0)
    torch.cuda.synchronize()
    moved = {k_: v_ - before[k_] for k_, v_ in flash_attention.variant_launches.items()}
    assert moved == {k_: int(k_ == "wgmma") for k_ in moved}, moved
    ref = flash_attention_ref(q, k, v, causal=True, window=window, softcap=0.0)
    err = (o.float() - ref.float()).abs().max().item()
    assert err <= _bf16_ulps(ref), (err, _bf16_ulps(ref))


@pytest.mark.parametrize("M,K,N,expected", [
    (8192, 12288, 4096, "prefill"), (8192, 4096, 12288, "prefill"),  # recurrentgemma's MLP
    (2, 12288, 4096, "decode"), (2, 4096, 12288, "decode"),
    (8, 8192, 4096, "decode"),  # qwen3's wo at decode
])
def test_lora_at_the_hybrid_and_moe_widths(cuda, M, K, N, expected):
    """LoRA at recurrentgemma-9b's K=12288 down projection (and its up
    projection) and qwen3's wo, prefill and decode, against lora_matmul_ref."""
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=gen, device=cuda).bfloat16()
    w, a, b = (torch.randn(s, generator=gen, device=cuda).mul(0.05).bfloat16()
               for s in ((K, N), (K, 16), (16, N)))
    before = dict(lora_matmul.variant_launches)
    y = lora_matmul(x, w, a, b, scale=2.0)
    torch.cuda.synchronize()
    moved = {k_: v_ - before[k_] for k_, v_ in lora_matmul.variant_launches.items()}
    assert moved == {k_: int(k_ == expected) for k_ in moved}, moved
    ref = lora_matmul_ref(x, w, a, b, scale=2.0)
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= _bf16_ulps(ref), (err, _bf16_ulps(ref))


def test_flash_wrapper_raises_on_other_head_dims(cuda):
    """Head dims outside HEAD_DIMS (16-256) raise on the card; none falls
    back to the plain version."""
    for d in (48, 96, 512):
        q = torch.zeros((1, 2, 8, d), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(q, q[:, :1], q[:, :1])


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_misaligned_rows_take_the_wmma_variant(cuda, d):
    """Views whose rows are not 16-byte aligned cannot be read by TMA: the
    first port's kernel takes them at every head dim that wgmma takes."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    buf = torch.randn((2 * 100 * 4 * d + 1,), generator=gen, device=cuda).bfloat16()
    q = buf[1:].view(2, 100, 4, d).transpose(1, 2)  # one element off
    k = torch.randn((2, 100, 2, d), generator=gen, device=cuda).bfloat16().transpose(1, 2)
    before = flash_attention.variant_launches["wmma"]
    o = flash_attention(q, k, k, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.variant_launches["wmma"] == before + 1
    ref = flash_attention_ref(q, k, k, causal=True)
    assert (o.float() - ref.float()).abs().max().item() <= _bf16_ulps(ref)


def test_bf16_smoke_serving_runs_the_kernels(cuda):
    """Prefill + one decode step of the bf16 smoke model: kernel path (fused
    LoRA, flash) against the plain path (merged weights, _attend_full)."""
    cfg = smoke_variant(get_arch("fedsllm-100m")).replace(dtype="bfloat16",
                                                          param_dtype="bfloat16")
    params = T.init_params(cfg, seed=0, device=cuda)
    lora = init_lora(params, cfg, seed=1, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    for ab in lora.values():
        ab["B"] = (torch.randn(ab["B"].shape, generator=gen, device=cuda) * 0.05).bfloat16()
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen, device=cuda)
    merged = merge(params, lora, cfg)
    lm0, fa0 = lora_matmul.launches, flash_attention.launches
    cache = T.init_cache(cfg, 2, 48, device=cuda)
    logits, cache = T.prefill(params, {"tokens": tokens}, cfg, cache, lora=lora)
    step, cache = T.decode_step(params, tokens[:, -1:], cache, 40, cfg, lora=lora)
    torch.cuda.synchronize()
    assert lora_matmul.launches - lm0 == 2 * 7 * cfg.num_layers
    assert flash_attention.launches - fa0 == cfg.num_layers
    plain_cache = T.init_cache(cfg, 2, 48, device=cuda)
    ref, plain_cache = T.prefill(merged, {"tokens": tokens}, cfg, plain_cache, kernels=False)
    ref_step, _ = T.decode_step(merged, tokens[:, -1:], plain_cache, 40, cfg)
    for got, want in ((logits, ref), (step, ref_step)):
        assert torch.isfinite(got).all()
        rel = ((got - want).norm() / want.norm()).item()
        assert rel <= 2e-2, rel


def _ssd_inputs(cuda, B, S, H, P, N, dtype, h0, seed):
    """Drawn as tests/test_kernels.py draws the reference's SSD cases."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=gen, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=cuda))
    A = -torch.exp(torch.randn((H,), generator=gen, device=cuda) * 0.3)
    Bm = (torch.randn((B, S, N), generator=gen, device=cuda) * 0.5).to(dtype)
    Cm = (torch.randn((B, S, N), generator=gen, device=cuda) * 0.5).to(dtype)
    state = torch.randn((B, H, P, N), generator=gen, device=cuda) if h0 else None
    return x, dt, A, Bm, Cm, state


@pytest.mark.parametrize("B,S,H,P,N,dtype,h0", [
    (8, 512, 24, 64, 128, torch.bfloat16, True),  # the mamba2-130m prefill
    (2, 200, 24, 64, 128, torch.float32, False),  # ragged S
    (2, 2048, 4, 64, 128, torch.float32, True),  # many chunks
    (2, 70, 3, 24, 40, torch.float32, True),  # P, N not multiples of 16
    (1, 33, 1, 8, 8, torch.float32, False),  # H = 1, one step past a chunk
    (3, 1, 2, 16, 16, torch.float32, True),  # S = 1
    (2, 40, 8, 16, 16, torch.bfloat16, False),  # smoke widths
    (1, 64, 2, 100, 200, torch.float32, True),  # beyond one thread tile
])
def test_ssd_kernel_matches_plain(cuda, B, S, H, P, N, dtype, h0):
    x, dt, A, Bm, Cm, state = _ssd_inputs(cuda, B, S, H, P, N, dtype, h0, seed=S + P)
    before = ssd_scan.launches
    y, h = ssd_scan(x, dt, A, Bm, Cm, initial_state=state)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == h.dtype == torch.float32 and y.shape == x.shape and h.shape == (B, H, P, N)
    yr, hr = ssd_scan_ref(x, dt, A, Bm, Cm, state)
    # 1e-4 of the largest output, the reference's own SSD tolerance: both
    # sides compute in fp32, the kernel in chunks (exp of cumulative sums
    # for products of per-step decays, sums in another order)
    for got, want in ((y, yr), (h, hr)):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (err, want.abs().max().item())


def test_ssd_kernel_reads_strided_views(cuda):
    """x, Bm, Cm as the model hands them over: views of one (B, S, conv_ch)
    tensor, not contiguous."""
    B, S, H, P, N = 2, 100, 4, 32, 24
    gen = torch.Generator(device=cuda).manual_seed(5)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen, device=cuda).bfloat16()
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=cuda))
    A = -torch.exp(torch.randn((H,), generator=gen, device=cuda))
    assert not (x.is_contiguous() or Bm.is_contiguous())
    y, h = ssd_scan(x, dt, A, Bm, Cm)
    yr, hr = ssd_scan_ref(x, dt, A, Bm, Cm)
    for got, want in ((y, yr), (h, hr)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_ssd_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, dt, A, Bm, Cm, state = _ssd_inputs(cuda, 1, 16, 2, 8, 8, torch.float32, True, seed=0)
    with pytest.raises(TypeError):
        ssd_scan(x.half(), dt, A, Bm.half(), Cm.half())  # fp16
    with pytest.raises(TypeError):
        ssd_scan(x, dt.bfloat16(), A, Bm, Cm)  # dt not fp32
    with pytest.raises(TypeError):
        ssd_scan(x, dt, A, Bm, Cm, initial_state=state.bfloat16())
    with pytest.raises(ValueError):
        ssd_scan(x.transpose(1, 3).contiguous().transpose(1, 3), dt, A, Bm, Cm)  # P strided
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm, Cm, initial_state=state.transpose(-1, -2))
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm.cpu(), Cm)  # mixed devices
    big = _ssd_inputs(cuda, 1, 4, 1, 256, 256, torch.float32, False, seed=0)
    with pytest.raises(ValueError, match="shared"):
        ssd_scan(*big[:5])  # the (P, N) state does not fit a block's shared memory


def test_bf16_smoke_mamba2_serving_runs_the_kernels(cuda):
    """Prefill + one decode step of the bf16 smoke mamba2: kernel path (fused
    LoRA, SSD scan) against the plain path (merged weights, ssd_chunked)."""
    cfg = smoke_variant(get_arch("mamba2-130m")).replace(dtype="bfloat16",
                                                         param_dtype="bfloat16")
    params = T.init_params(cfg, seed=0, device=cuda)
    lora = init_lora(params, cfg, seed=1, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    for ab in lora.values():
        ab["B"] = (torch.randn(ab["B"].shape, generator=gen, device=cuda) * 0.05).bfloat16()
    m = params["groups"]["sub_0"]["mamba"]  # per-head values, not the uniform init
    m["A_log"] = torch.rand(m["A_log"].shape, generator=gen, device=cuda) * 2
    m["D_skip"] = 1 + torch.randn(m["D_skip"].shape, generator=gen, device=cuda) * 0.5
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen, device=cuda)
    merged = merge(params, lora, cfg)
    lm0, fa0, ss0 = lora_matmul.launches, flash_attention.launches, ssd_scan.launches
    cache = T.init_cache(cfg, 2, 48, device=cuda)
    logits, cache = T.prefill(params, {"tokens": tokens}, cfg, cache, lora=lora)
    step, cache = T.decode_step(params, tokens[:, -1:], cache, 40, cfg, lora=lora)
    torch.cuda.synchronize()
    assert lora_matmul.launches - lm0 == 2 * 2 * cfg.num_layers  # in_proj, out_proj
    assert ssd_scan.launches - ss0 == cfg.num_layers  # prefill only
    assert flash_attention.launches == fa0
    plain_cache = T.init_cache(cfg, 2, 48, device=cuda)
    ref, plain_cache = T.prefill(merged, {"tokens": tokens}, cfg, plain_cache, kernels=False)
    ref_step, _ = T.decode_step(merged, tokens[:, -1:], plain_cache, 40, cfg)
    for got, want in ((logits, ref), (step, ref_step)):
        assert torch.isfinite(got).all()
        rel = ((got - want).norm() / want.norm()).item()
        assert rel <= 2e-2, rel


def _ssd_views(cuda, B, S, H, P, N, h0, seed):
    """bf16 x, Bm, Cm as the mamba2 prefill hands them over: views of one
    (B, S, H·P + 2N) tensor (the conv output), not contiguous."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen, device=cuda).mul(0.5).bfloat16()
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=cuda) - 2)
    A = -torch.exp(torch.randn((H,), generator=gen, device=cuda))
    state = torch.randn((B, H, P, N), generator=gen, device=cuda) if h0 else None
    return x, dt, A, Bm, Cm, state


@pytest.mark.parametrize("B,S,H,P,N,h0", [
    (8, 512, 24, 64, 128, True),  # the mamba2-130m prefill
    (2, 200, 24, 64, 128, True),  # ragged S
    (2, 2048, 4, 64, 128, True),  # many chunks
    (3, 1, 4, 64, 128, True),  # S = 1
    (2, 65, 4, 64, 128, False),  # one step past a chunk
    (2, 40, 2, 32, 64, True),  # the narrowest widths the variant takes
    (1, 100, 3, 96, 192, True),  # three P slices, N = 192
    (1, 130, 2, 32, 256, False),  # N = 256
])
def test_ssd_wgmma_matches_plain(cuda, B, S, H, P, N, h0):
    x, dt, A, Bm, Cm, state = _ssd_views(cuda, B, S, H, P, N, h0, seed=S + N)
    before = dict(ssd_scan.variant_launches)
    y, h = ssd_scan(x, dt, A, Bm, Cm, initial_state=state)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in ssd_scan.variant_launches.items()}
    assert moved == {"wgmma": 1, "fma": 0}, moved
    yr, hr = ssd_scan_ref(x, dt, A, Bm, Cm, state)
    # 1e-4 of the largest output, the reference's own SSD tolerance: the
    # variant's fp32 operands (G, h, w·x) go in as two bf16 terms each
    for got, want in ((y, yr), (h, hr)):
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (err, want.abs().max().item())


@pytest.mark.parametrize("dtype,P,N,offset,expected", [
    (torch.bfloat16, 64, 128, 0, "wgmma"),
    (torch.float32, 64, 128, 0, "fma"),
    (torch.bfloat16, 24, 40, 0, "fma"),  # P not a multiple of 32, N not of 64
    (torch.bfloat16, 64, 320, 0, "fma"),  # N over 256
    (torch.bfloat16, 64, 128, 1, "fma"),  # views not 16-byte aligned
])
def test_ssd_variants_route_by_shape_dtype_and_alignment(cuda, dtype, P, N, offset, expected):
    B, S, H = 2, 70, 2
    gen = torch.Generator(device=cuda).manual_seed(P + N + offset)
    buf = torch.randn((B * S * (H * P + 2 * N) + offset,), generator=gen, device=cuda)
    xbc = buf.mul(0.5).to(dtype)[offset:].view(B, S, H * P + 2 * N)
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=cuda))
    A = -torch.exp(torch.randn((H,), generator=gen, device=cuda) * 0.3)
    before = dict(ssd_scan.variant_launches)
    y, h = ssd_scan(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in ssd_scan.variant_launches.items()}
    assert moved == {k: int(k == expected) for k in moved}, moved
    yr, hr = ssd_scan_ref(x, dt, A, Bm, Cm)
    for got, want in ((y, yr), (h, hr)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_ssd_wgmma_is_deterministic(cuda):
    """Every sum of the wgmma variant has a fixed order: the same inputs give
    the same bits."""
    x, dt, A, Bm, Cm, state = _ssd_views(cuda, 2, 300, 8, 64, 128, True, seed=9)
    y0, h0 = ssd_scan(x, dt, A, Bm, Cm, initial_state=state)
    for _ in range(3):
        y, h = ssd_scan(x, dt, A, Bm, Cm, initial_state=state)
        assert torch.equal(y, y0) and torch.equal(h, h0)


# ---------------------------------------------------------------------------
# training: the round runs no kernel, and the card computes what the CPU does
# ---------------------------------------------------------------------------


def _smoke_train(K=2):
    cfg = smoke_variant(get_arch("fedsllm-100m"))
    state = fedsllm.init_state(cfg, cut=1, seed=0, device="cpu")
    batches = client_batches(TokenStream(2, 16, cfg.vocab_size, device="cpu"), 0, K)
    return cfg, state, batches


@pytest.fixture
def no_tf32():
    """fp32 products in full fp32 on the card, as on the CPU."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("algo", ["gd", "scaffold"])
def test_smoke_round_on_card_equals_cpu_and_launches_no_kernel(cuda, no_tf32, algo):
    """One round of smoke fedsllm-100m (fp32) on the card against the same
    round on the CPU: adapters and metrics within 1e-4 of the largest value;
    the kernels' launch counters stay at 0 (training runs no kernel)."""
    cfg, state, batches = _smoke_train()
    fcfg = FedsLLMConfig(num_clients=2)
    fn = fedsllm.build_round_fn(cfg, fcfg, 1, 0.9, local_algo=algo)
    extra = ()
    if algo == "scaffold":
        variates = fn.local_algo.init_variates((state.lora_c, state.lora_s), 3)
        variates = tree_map(lambda v: v + 0.01, variates)
        extra = (None, None, None, None, None, variates, torch.tensor([2, 0]))
    want = fn(state, batches, *extra)
    counts = {k: f.launches for k, f in (("lora", lora_matmul), ("flash", flash_attention),
                                         ("ssd", ssd_scan))}
    moved = lambda t: tree_map(lambda v: v.to(cuda) if isinstance(v, torch.Tensor) else v, t)
    got = fn(moved(state), moved(batches), *moved(extra))
    torch.cuda.synchronize()
    assert counts == {k: f.launches for k, f in (("lora", lora_matmul), ("flash", flash_attention),
                                                 ("ssd", ssd_scan))}
    assert all(v.device.type == cuda.type for v in tree_leaves(got[0].lora_c))
    for g, w in zip(got, want):
        if isinstance(w, fedsllm.FedsLLMState):
            g, w = (g.lora_c, g.lora_s), (w.lora_c, w.lora_s)
        assert tree_rel_gap(g, w) <= 1e-4, tree_rel_gap(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_equals_monolithic_on_card(cuda, no_tf32, dtype):
    cfg, state, batches = _smoke_train()
    cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    to = lambda t: t.to(device=cuda, dtype=getattr(torch, dtype)) if t.is_floating_point() \
        else t.to(cuda)
    base, lc, ls = (tree_map(to, t) for t in (state.base, state.lora_c, state.lora_s))
    gen = torch.Generator(device=cuda).manual_seed(0)
    for ab in list(lc.values()) + list(ls.values()):  # B = 0 at init hides dA
        ab["B"] = (0.01 * torch.randn(ab["B"].shape, generator=gen, device=cuda)).to(ab["B"].dtype)
    batch = {k: v[0].to(cuda) for k, v in batches.items()}
    loss, dc, ds, _ = split.split_value_and_grad(base, lc, ls, batch, cfg, 1)
    mloss, mdc, mds = split.monolithic_value_and_grad(base, lc, ls, batch, cfg, 1)
    assert torch.equal(loss, mloss)
    for a, b in zip(tree_leaves((dc, ds)), tree_leaves((mdc, mds))):
        assert a.dtype == b.dtype == getattr(torch, dtype)
        assert ((a.float() - b.float()).norm() / b.float().norm()).item() <= 1e-5


def test_kernel_wrappers_raise_on_cuda_inputs_requiring_grad(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=gen, device=cuda).bfloat16()
    x, w, a, b = r(16, 64), r(64, 64), r(64, 16), r(16, 64)
    q, k, v = r(1, 4, 32, 64), r(1, 2, 32, 64), r(1, 2, 32, 64)
    xs, bm, cm = r(1, 64, 2, 64), r(1, 64, 64), r(1, 64, 64)
    dt = torch.rand((1, 64, 2), generator=gen, device=cuda)
    A = -torch.rand((2,), generator=gen, device=cuda)
    before = (lora_matmul.launches, flash_attention.launches, ssd_scan.launches)
    for call in (lambda: lora_matmul(x, w, a.requires_grad_(), b, scale=2.0),
                 lambda: flash_attention(q.requires_grad_(), k, v),
                 lambda: ssd_scan(xs, dt.requires_grad_(), A, bm, cm)):
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
    assert (lora_matmul.launches, flash_attention.launches, ssd_scan.launches) == before


def test_concrete_like_on_the_card(cuda):
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import specs as SP

    cfg = smoke_variant(get_arch("whisper-base"))
    specs = SP.cell_specs(cfg, ShapeConfig("d", "decode", 64, 3))
    a, b = (SP.concrete_like(specs, seed=4, device=cuda) for _ in range(2))
    for x, y, s in zip(tree_leaves(a), tree_leaves(b), tree_leaves(specs)):
        assert x.device.type == "cuda" and x.shape == s.shape and x.dtype == s.dtype
        assert torch.equal(x, y)
        if not x.dtype.is_floating_point:
            assert 0 <= int(x.min()) and int(x.max()) < 100


def test_measure_cell_at_a_smoke_config(cuda):
    """M1, M2 and the composition present; launches counted by variant (the
    smoke config is fp32: LoRA and flash on their fp32 variants)."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun

    cfg = smoke_variant(get_arch("fedsllm-100m")).replace(num_layers=4)
    rec = dryrun.measure_cell(cfg, ShapeConfig("p", "prefill", 64, 4), cuda)
    assert rec["fits"] and rec["b"] == 4 and set(rec["depths"]) == {"m1", "m2"}
    for key in ("m1", "m2"):
        run = rec[key]
        assert run["ms"] > 0 and run["transient_bytes"] >= 0
        assert run["launches"]["lora_matmul"]["fp32"] == 7 * run["layers"]
        assert run["launches"]["flash_attention"]["fp32"] == run["layers"]
        assert run["resident_bytes"] == dryrun.resident_bytes(
            cfg.replace(num_layers=run["layers"]), ShapeConfig("p", "prefill", 64, 4))
    assert rec["composed"]["ms"] > 0 and rec["at_global_batch"]["extrapolated"] is False


def _row_ulps(o, ref, n=2.0):
    """Each query row's largest error over n bf16 ulps of that row's largest
    output, the worst row's: a row that attends over N keys has outputs of
    about sqrt(e/N), far below the first row's."""
    ref = ref.float()
    return ((o.float() - ref).abs().amax(-1) / (n * 2.0 ** -7 * ref.abs().amax(-1))).max().item()


def test_flash_and_lora_at_a_32k_prefill(cuda):
    """gemma2-9b's prefill at 32,768 positions (d=256, softcap 50, GQA 16/8),
    each query row within 2 bf16 ulps of its own largest output, and its
    widest LoRA product at M = 32,768, against their plain versions. The
    kernel with the last rows' first 64 keys dropped (window S - 64) fails
    the row check."""
    gen = torch.Generator(device=cuda).manual_seed(32)
    S = 32768
    q = torch.randn((1, 16, S, 256), generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn((1, 8, S, 256), generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    before = dict(flash_attention.variant_launches)
    o = flash_attention(q, k, v, causal=True, softcap=50.0)
    torch.cuda.synchronize()
    assert flash_attention.variant_launches["wgmma"] == before["wgmma"] + 1
    ref = flash_attention_fp32(q, k, v, causal=True, softcap=50.0, q_chunk=2048)
    assert _row_ulps(o, ref) <= 1
    dropped = flash_attention(q, k, v, causal=True, window=S - 64, softcap=50.0)
    assert _row_ulps(dropped, ref) > 1
    del q, k, v, o, dropped, ref
    x = torch.randn((S, 14336), generator=gen, device=cuda).bfloat16()
    w, a, b = (torch.randn(s, generator=gen, device=cuda).mul(0.05).bfloat16()
               for s in ((14336, 3584), (14336, 16), (16, 3584)))
    before = dict(lora_matmul.variant_launches)
    y = lora_matmul(x, w, a, b, scale=2.0)
    torch.cuda.synchronize()
    assert lora_matmul.variant_launches["prefill"] == before["prefill"] + 1
    ref = lora_matmul_ref(x, w, a, b, scale=2.0)
    assert (y.float() - ref.float()).abs().max().item() <= _bf16_ulps(ref)
