"""StarCoder2-7B [arXiv:2402.19173]: 32L, d=4608, 36H GQA(kv=4), ff=18432,
vocab=49152. GQA + RoPE, GELU MLP, LayerNorm with bias (starcoder2 style).
(The port's copy of ``repro/configs/starcoder2_7b.py``.)"""

from repro_torch.config import ModelConfig, register_arch


@register_arch("starcoder2-7b")
def starcoder2_7b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49152,
        mlp_activation="gelu",
        norm_type="layernorm",
        use_bias=True,
        use_rope=True,
        rope_theta=1e5,
        layer_pattern="G",
    )
