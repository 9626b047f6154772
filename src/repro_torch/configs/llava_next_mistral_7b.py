"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf]:
32L, d=4096, 32H GQA(kv=8), ff=14336, vocab=32000. Anyres tiling vision
frontend is a STUB: input_specs provides precomputed patch embeddings
(CLIP-L width 1024), projected by a 2-layer MLP into the LM stream.
(The port's copy of ``repro/configs/llava_next_mistral_7b.py``.)"""

from repro_torch.config import ModelConfig, register_arch


@register_arch("llava-next-mistral-7b")
def llava_next() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        mlp_activation="swiglu",
        norm_type="rmsnorm",
        use_rope=True,
        rope_theta=1e6,
        layer_pattern="G",
        vision_tokens=2880,  # anyres: 576 base + 4 x 576 tile patches
    )
