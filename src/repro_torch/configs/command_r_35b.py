"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01]: 40L, d=8192, 64H
GQA(kv=8), ff=22528, vocab=256000. No-bias LayerNorm, parallel attn+mlp
blocks (Cohere style), tied embeddings with logit scale 0.0625.
(The port's copy of ``repro/configs/command_r_35b.py``.)"""

from repro_torch.config import ModelConfig, register_arch


@register_arch("command-r-35b")
def command_r_35b() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        num_layers=40,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22528,
        vocab_size=256_000,
        mlp_activation="swiglu",
        norm_type="layernorm",
        use_bias=False,
        use_rope=True,
        rope_theta=8e6,
        layer_pattern="G",
        parallel_block=True,
        tie_embeddings=True,
        logit_scale=0.0625,
    )
