"""Learning-rate schedules (pure functions of the step counter; port of
``repro/optim/schedules.py``).

Each returns a 0-dim fp32 tensor, computed in fp32 as ``jnp`` computes it:
the step becomes an fp32 tensor (on its own device, the CPU for a Python
int) and ``cos`` is taken of an fp32 tensor, not of a Python float, whose
``math.cos`` would round differently in the last bits. Python numbers next
to an fp32 tensor are rounded to fp32 first, as JAX's weakly typed scalars
are.
"""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device if isinstance(step, torch.Tensor)
                                     else None)


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        s = _step(step)
        w = torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)
        return lr * w

    return fn


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    def fn(step):
        s = _step(step)
        warm = torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1.0 - final_frac) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return lr * warm * cos

    return fn
