"""The frozen operation and byte counts at hand-worked shapes."""

from __future__ import annotations

import pytest

from portbench import libraries
from portbench.harness import flops

CFG = {"d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4, "d_ff": 16,
       "vocab_size": 32, "num_layers": 3, "lora": {"rank": 2}}


def test_lora_work_by_hand():
    # x 4x8, W 8x16, A 8x2, B 2x16, y 4x16 in bf16
    assert flops.lora_work(4, 8, 16, 2) == (2 * (32 + 128 + 16 + 32 + 64),
                                            2 * 4 * 8 * 16 + 2 * 4 * 8 * 2 + 2 * 4 * 2 * 16)


def test_attn_work_by_hand():
    # B=1, S=4 (10 causal pairs), 2 heads over 1, d=8
    assert flops.causal_pairs(4) == 10
    assert flops.attn_work(1, 4, 2, 1, 8) == (2 * (2 * 2 * 4 * 8 + 2 * 1 * 4 * 8), 4 * 2 * 10 * 8)


def test_least_time_is_the_longer_bound():
    assert flops.least_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert flops.least_s(1.0, 989e12) == pytest.approx(1.0)


def test_projections_of_a_layer():
    assert flops.projections(CFG) == [("wq", 8, 8), ("wk", 8, 4), ("wv", 8, 4), ("wo", 8, 8),
                                      ("w_gate", 8, 16), ("w_up", 8, 16), ("w_down", 16, 8)]


def test_forward_flops_by_hand():
    # T = 2·5 tokens; per layer Σ K·N = 64+32+32+64+128+128+128 = 576,
    # Σ (K+N) = 16+12+12+16+24+24+24 = 128
    per_layer = 2 * 10 * 576 + 2 * 10 * 2 * 128 + 4 * 2 * 2 * flops.causal_pairs(5) * 4
    assert flops.forward_flops(CFG, 2, 5, 1) == 3 * per_layer + 2 * 2 * 1 * 8 * 32
    head_rest = flops.forward_flops(CFG, 2, 5, 5) - flops.forward_flops(CFG, 2, 5, 1)
    assert head_rest == 2 * 2 * 4 * 8 * 32


def test_train_pass_flops_by_hand():
    T = 10
    fwd = flops.forward_flops(CFG, 2, 5, 5)
    per_layer = 2 * T * 576 + 4 * T * 2 * 128 + 8 * 2 * 2 * flops.causal_pairs(5) * 4
    first_qkv = 2 * T * (64 + 32 + 32) + 2 * T * 2 * (8 + 8 + 8)
    head = 2 * T * 8 * 32
    assert flops.train_pass_flops(CFG, 2, 5) == fwd + 3 * per_layer - first_qkv + head


def test_kernel_names_by_library():
    lora = ["void (anonymous namespace)::prefill::kernel<128, 64>(Ops)",
            "(anonymous namespace)::decode::kernel<16, 64, 0>",
            "(anonymous namespace)::fp32::tc_kernel<128>",
            "(anonymous namespace)::prefill::u_kernel"]
    flash = ["void (anonymous namespace)::tc::kernel<128, false>(Args)",
             "(anonymous namespace)::tf32x3::kernel<64>"]
    other = ["ampere_bf16_s16816gemm_bf16_128x128", "void at::native::elementwise_kernel<128, 4>"]
    pat = {name: libraries.get(name).KERNEL for name in ("lora_matmul", "flash_attention")}
    assert all(pat["lora_matmul"].search(n) and not pat["flash_attention"].search(n) for n in lora)
    assert all(pat["flash_attention"].search(n) and not pat["lora_matmul"].search(n)
               for n in flash)
    assert not any(p.search(n) for p in pat.values() for n in other)
