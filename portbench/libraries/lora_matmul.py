"""The fused LoRA matmul: ``kernels/lora_ops.py`` → ``csrc/lora_matmul.cu``."""

from __future__ import annotations

import re

from portbench.harness import flops

# CUDA C++ in an anonymous namespace: ``(anonymous namespace)::prefill::kernel<...>``
KERNEL = re.compile(r"::(prefill|decode|fp32)::\w*kernel\b")


def launches() -> int:
    from repro_torch.kernels.lora_ops import lora_matmul

    return lora_matmul.launches


def shapes(cfg: dict, B: int, S: int):
    """(M, K, N, r) of each adapted projection of each layer of a dense decoder."""
    if cfg.get("family", "dense") != "dense":
        return None
    r, targets = cfg["lora"]["rank"], set(cfg["lora"]["targets"])
    layer = [(B * S, K, N, r) for name, K, N in flops.projections(cfg) if name in targets]
    return layer * cfg["num_layers"]


def work(shape) -> tuple[int, int]:
    return flops.lora_work(*shape)
