"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-235B-A22B family]: 94L, d=4096, 64H
GQA(kv=4), expert ff=1536, vocab=151936, 128 experts top-8. QK-norm, SwiGLU
experts, RoPE, RMSNorm.
(The port's copy of ``repro/configs/qwen3_moe_235b_a22b.py``.)"""

from repro_torch.config import ModelConfig, register_arch


@register_arch("qwen3-moe-235b-a22b")
def qwen3_moe() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151_936,
        mlp_activation="swiglu",
        norm_type="rmsnorm",
        use_rope=True,
        rope_theta=1e6,
        qk_norm=True,
        layer_pattern="G",
        num_experts=128,
        num_experts_per_tok=8,
    )
