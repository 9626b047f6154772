"""The device a caller asked for (port's entry points default to the card)."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device a caller asked for; asking for CUDA without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is available; "
                           "pass device='cpu' to run the plain versions on the CPU")
    return dev
