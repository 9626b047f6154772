"""Gemma-2 9B [arXiv:2408.00118]: 42L, d=3584, 16H GQA(kv=8), head_dim=256,
ff=14336, vocab=256000. Alternating local(4096)/global attention, attn logit
softcap 50, final softcap 30, GeGLU, pre+post sandwich norms, tied embeddings,
embedding multiplier sqrt(d).
(The port's copy of ``repro/configs/gemma2_9b.py``.)"""

import math

from repro_torch.config import ModelConfig, register_arch


@register_arch("gemma2-9b")
def gemma2_9b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256_000,
        mlp_activation="geglu",
        norm_type="rmsnorm",
        use_rope=True,
        rope_theta=10_000.0,
        layer_pattern="LG",  # local, global alternating
        sliding_window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        use_post_norm=True,
        tie_embeddings=True,
        embedding_multiplier=math.sqrt(3584.0),
    )
