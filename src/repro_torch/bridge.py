"""Bring the reference's parameters, round state, optimizer state and
batches into the port, and the port's adapters and optimizer state back out.

The reference's trees hold JAX arrays; its side turns them into numpy
(``jax.device_get`` / ``np.asarray``) and these functions make the port's
tensors of them, keeping the tree and the adapters' key strings as they are.
bfloat16 arrays (numpy's ``ml_dtypes`` type) arrive as bfloat16 tensors.
The tensors go to the card unless the caller names another device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fedsllm import FedsLLMState
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


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


def state_from_numpy(base, lora_c, lora_s, round=0, device="cuda") -> FedsLLMState:
    """The reference's ``FedsLLMState`` fields (numpy trees, round number)
    as the port's state."""
    device = resolve_device(device)
    return FedsLLMState(params_from_numpy(base, device), lora_from_numpy(lora_c, device),
                        lora_from_numpy(lora_s, device),
                        torch.tensor(int(round), dtype=torch.int32, device=device))


def batches_from_numpy(batches, device="cuda"):
    """A batch dict of numpy arrays (stacked (K, ...) or not) as tensors;
    integer arrays (tokens, labels) become int64, as the port indexes with."""
    device = resolve_device(device)
    return {k: (torch.from_numpy(np.asarray(v).astype(np.int64)).to(device)
                if np.issubdtype(np.asarray(v).dtype, np.integer) else tensor_from_numpy(v, device))
            for k, v in batches.items()}


def opt_state_from_numpy(state, device="cuda"):
    """The reference's optimizer state as tensors, its tree kept: adamw's
    ``{"m", "v"}``, sgd's ``{"m"}`` (``{}`` without momentum) and adafactor's
    ``{"f"}``, whose leaves are ``{"r", "c"}`` or ``{"v"}`` dicts."""
    return params_from_numpy(state, device)


def opt_state_to_numpy(state):
    """An optimizer state of the port as numpy arrays (bfloat16 moments as
    float32), for comparison with the reference's."""
    return lora_to_numpy(state)


def lora_to_numpy(tree):
    """A tree of tensors (adapters, gradients, variates) as numpy arrays on
    the host; bfloat16 comes out as float32, which holds it exactly."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, tree)
