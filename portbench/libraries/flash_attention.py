"""Flash attention: ``kernels/attn_ops.py`` → ``csrc/flash_attention.cu``."""

from __future__ import annotations

import re

from portbench.harness import flops

KERNEL = re.compile(r"::(tc|tf32x3)::kernel\b")


def launches() -> int:
    from repro_torch.kernels.attn_ops import flash_attention

    return flash_attention.launches


def shapes(cfg: dict, B: int, S: int):
    """(B, S, H, Kv, d) of each layer's causal self-attention of a dense decoder."""
    if cfg.get("family", "dense") != "dense":
        return None
    return [(B, S, cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"])] * cfg["num_layers"]


def work(shape) -> tuple[int, int]:
    return flops.attn_work(*shape)
