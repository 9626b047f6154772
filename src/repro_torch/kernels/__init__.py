"""Hand-written CUDA kernels of the port, one per Pallas kernel of the
reference on the ported path. Each has ``<name>.py`` (the ctypes binding of
``csrc/<name>.cu``), a wrapper ``*_ops.py`` and its plain PyTorch version
``*_ref.py``. Like the Pallas kernels, they are forward-only."""

import torch


def require_no_grad(name: str, *tensors) -> None:
    """Raise where autograd would record through kernel ``name``: it has no
    backward, so an input's gradient would be lost without a word. Checked on
    every device, the plain versions' too, so that CPU tests catch it."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernels are forward-only; training "
            "merges the adapters (core.lora.merge) and attends through layers._attend_full "
            "(kernels=False), as the reference does")
