"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427]: 38L, d=4096, 16H MQA(kv=1),
ff=12288, lru_width=4096, local attention window 2048, pattern 2 recurrent :
1 local-attention (RRL). GeGLU, RMSNorm, embedding multiplier sqrt(d).
(The port's copy of ``repro/configs/recurrentgemma_9b.py``.)"""

import math

from repro_torch.config import ModelConfig, register_arch


@register_arch("recurrentgemma-9b")
def recurrentgemma_9b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,  # = 12 x (R,R,L) + (R,R) tail
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        mlp_activation="geglu",
        norm_type="rmsnorm",
        use_rope=True,
        rope_theta=10_000.0,
        layer_pattern="RRL",
        sliding_window=2048,
        lru_width=4096,
        tie_embeddings=True,
        embedding_multiplier=math.sqrt(4096.0),
    )
