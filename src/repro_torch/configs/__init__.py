"""Architecture configs — importing this package registers them."""

from repro_torch.configs import fedsllm_paper, mamba2_130m  # noqa: F401
