"""Whisper-base [arXiv:2212.04356]: enc-dec, 6L each, d=512, 8H MHA, ff=2048,
vocab=51865. Conv audio frontend is a STUB: input_specs provides precomputed
frame embeddings (B, 1500, 512). Learned positional embeddings, GELU,
LayerNorm. Decoder cross-attends to the encoder.
(The port's copy of ``repro/configs/whisper_base.py``.)"""

from repro_torch.config import ModelConfig, register_arch


@register_arch("whisper-base")
def whisper_base() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="encdec",
        num_layers=6,
        num_encoder_layers=6,
        encoder_seq=1500,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51_865,
        mlp_activation="gelu",
        norm_type="layernorm",
        use_bias=True,
        use_rope=False,  # learned absolute positions
        layer_pattern="G",
        tie_embeddings=True,
    )
