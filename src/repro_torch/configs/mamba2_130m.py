"""Mamba2-130M [arXiv:2405.21060]: 24L, d=768, attention-free SSD,
ssm_state=128, vocab=50280. expand=2 -> d_inner=1536, head_dim=64 (24 heads),
chunk=256 (the port's copy of ``repro/configs/mamba2_130m.py``)."""

from repro_torch.config import ModelConfig, register_arch


@register_arch("mamba2-130m")
def mamba2_130m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=12,  # unused by SSD path (ssm heads derived from expand*d/hd)
        num_kv_heads=12,
        head_dim=64,
        d_ff=0,
        vocab_size=50280,
        norm_type="rmsnorm",
        use_rope=False,
        layer_pattern="M",
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        tie_embeddings=True,
    )
