"""Phi-4-mini 3.8B [arXiv:2412.08905]: 32L, d=3072, 24H GQA(kv=8), ff=8192,
vocab=200064. RoPE + SwiGLU + GQA, RMSNorm.
(The port's copy of ``repro/configs/phi4_mini_3_8b.py``.)"""

from repro_torch.config import ModelConfig, register_arch


@register_arch("phi4-mini-3.8b")
def phi4_mini() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=200_064,
        mlp_activation="swiglu",
        norm_type="rmsnorm",
        use_rope=True,
        rope_theta=10_000.0,
        layer_pattern="G",
        tie_embeddings=True,
    )
