"""Optimizers, schedules and gradient utilities of the port (the
reference's ``repro.optim``), over trees of tensors."""

from repro_torch.optim.optimizers import Optimizer, adamw, adafactor, sgd
from repro_torch.optim.schedules import constant, cosine_with_warmup, linear_warmup
from repro_torch.optim.grad_utils import clip_by_global_norm, global_norm

__all__ = [
    "Optimizer",
    "adamw",
    "adafactor",
    "sgd",
    "constant",
    "cosine_with_warmup",
    "linear_warmup",
    "clip_by_global_norm",
    "global_norm",
]
