"""Architecture configs — importing this package registers them."""

from repro_torch.configs import (  # noqa: F401
    command_r_35b,
    fedsllm_paper,
    gemma2_9b,
    llava_next_mistral_7b,
    mamba2_130m,
    olmoe_1b_7b,
    phi4_mini_3_8b,
    qwen3_moe_235b_a22b,
    recurrentgemma_9b,
    starcoder2_7b,
    whisper_base,
)
