"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA GPU and skips without one: a CUDA kernel has no
CPU mode. This file imports neither ``jax`` nor ``repro``, so it also runs on
a machine with the card and without JAX; there the repository's
``conftest.py`` (which imports JAX) is skipped:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.config import get_arch, smoke_variant
from repro_torch.core.lora import init_lora, merge
from repro_torch.kernels.attn_ops import flash_attention
from repro_torch.kernels.attn_ref import flash_attention_ref
from repro_torch.kernels.lora_ops import lora_matmul
from repro_torch.kernels.lora_ref import lora_matmul_ref
from repro_torch.models import transformer as T

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


def test_lora_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, w, a, b = (torch.randn(s, device=cuda) for s in ((8, 64), (64, 32), (64, 4), (4, 32)))
    with pytest.raises(TypeError):
        lora_matmul(x, w, a, b)  # fp32
    x, w = x.bfloat16(), w.bfloat16()
    a, b = torch.randn((64, 80), device=cuda).bfloat16(), torch.randn((80, 32), device=cuda).bfloat16()
    with pytest.raises(ValueError):
        lora_matmul(x, w, a, b)  # rank above 64


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
    ref, plain_cache = T.prefill(merged, {"tokens": tokens}, cfg, plain_cache, flash=False)
    ref_step, _ = T.decode_step(merged, tokens[:, -1:], plain_cache, 40, cfg)
    for got, want in ((logits, ref), (step, ref_step)):
        assert torch.isfinite(got).all()
        rel = ((got - want).norm() / want.norm()).item()
        assert rel <= 2e-2, rel
