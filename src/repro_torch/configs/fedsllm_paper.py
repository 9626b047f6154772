"""The ~100M decoder LM of the paper's experimental setting (see
``repro/configs/fedsllm_paper.py`` for the wireless constants, which the
serving port does not read)."""

from repro_torch.config import LoRAConfig, ModelConfig, register_arch


@register_arch("fedsllm-100m")
def fedsllm_100m() -> ModelConfig:
    return ModelConfig(
        name="fedsllm-100m",
        family="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=32_000,
        mlp_activation="swiglu",
        norm_type="rmsnorm",
        use_rope=True,
        layer_pattern="G",
        lora=LoRAConfig(rank=16, alpha=32.0),
    )
