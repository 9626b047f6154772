"""OLMoE-1B-7B [arXiv:2409.02060]: 16L, d=2048, 16H (kv=16 -> MHA), expert
ff=1024, vocab=50304, 64 experts top-8. RMSNorm + SwiGLU experts + RoPE +
qk-norm.
(The port's copy of ``repro/configs/olmoe_1b_7b.py``.)"""

from repro_torch.config import ModelConfig, register_arch


@register_arch("olmoe-1b-7b")
def olmoe() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab_size=50304,
        mlp_activation="swiglu",
        norm_type="rmsnorm",
        use_rope=True,
        rope_theta=10_000.0,
        qk_norm=True,
        layer_pattern="G",
        num_experts=64,
        num_experts_per_tok=8,
    )
