"""Bring the reference's parameters into the port.

The reference's trees hold JAX arrays; its side turns them into numpy
(``jax.device_get`` / ``np.asarray``) and these functions make the port's
tensors of them, keeping the tree and the adapters' key strings as they are.
bfloat16 arrays (numpy's ``ml_dtypes`` type) arrive as bfloat16 tensors.
The tensors go to the card unless the caller names another device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_numpy(tree, device="cuda"):
    """A nested dict of numpy arrays (the reference's parameter tree) as tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def lora_from_numpy(lora, device="cuda"):
    """The reference's adapters ``{keystr: {"A", "B"}}`` as tensors."""
    return params_from_numpy(lora, device)
