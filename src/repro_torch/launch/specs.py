"""Input specs: meta tensors standing in for every model input (port of
``repro/launch/specs.py``).

The PyTorch idiom for ``jax.ShapeDtypeStruct`` is a tensor on the meta
device: a shape and a dtype, no storage. The modality frontends are stubs,
as in the reference: the vlm cell gets precomputed CLIP-L patch embeddings
(B, Tv, 1024), Tv = min(vision_tokens, S // 2); the audio cell gets
precomputed log-mel frame embeddings (B, 1500, d_model). Tokens, labels and
the decode position take the port's token dtype, int64, where the reference
has int32.

``concrete_like`` materialises a spec tree on a device from a seeded
``torch.Generator``; its values cannot equal ``jax.random``'s.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_like

TOKEN_DTYPE = torch.int64


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (``ShapeDtypeStruct``)."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    dt = L.torch_dtype(cfg.dtype)
    batch: dict[str, Any] = {}
    Tv = 0
    if cfg.family == "vlm":
        Tv = min(cfg.vision_tokens, S // 2)
        batch["vision_embeds"] = sds((B, Tv, T.VISION_WIDTH), dt)
    if cfg.family == "encdec":
        batch["frame_embeds"] = sds((B, cfg.encoder_seq, cfg.d_model), dt)
    batch["tokens"] = sds((B, S - Tv), TOKEN_DTYPE)
    batch["labels"] = sds((B, S), TOKEN_DTYPE)
    batch["mask"] = sds((B, S), torch.float32)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    return train_batch_specs(cfg, shape)


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig) -> torch.Tensor:
    return sds((shape.global_batch, 1), TOKEN_DTYPE)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The KV/state cache tree on the meta device (no allocation)."""
    return T.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")


def enc_out_specs(cfg: ModelConfig, shape: ShapeConfig):
    if cfg.family != "encdec":
        return None
    return sds((shape.global_batch, cfg.encoder_seq, cfg.d_model), L.torch_dtype(cfg.dtype))


def cell_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """``input_specs`` of a config and shape (any batch, any depth):
    training and prefill cells: {tokens, labels, mask} (+ the modality
    stubs); decode: {tokens (B, 1), cache, pos} (+ ``enc_out`` for encdec)."""
    if shape.kind in ("train", "prefill"):
        return train_batch_specs(cfg, shape)
    out = {"tokens": decode_token_specs(cfg, shape), "cache": cache_specs(cfg, shape),
           "pos": sds((), TOKEN_DTYPE)}
    if cfg.family == "encdec":
        out["enc_out"] = enc_out_specs(cfg, shape)
    return out


def input_specs(arch: str, shape_name: str = "train_4k") -> dict[str, Any]:
    """Meta-tensor stand-ins for every model input of a cell (``cell_specs``
    of the registered arch and shape)."""
    from repro_torch.config import SHAPES, get_arch

    return cell_specs(get_arch(arch), SHAPES[shape_name])


def concrete_like(specs, seed: int = 0, scale: float = 1.0, device="cuda"):
    """A spec tree materialised on ``device``, leaf by leaf in tree order
    from one ``torch.Generator`` seeded with ``seed``: integer leaves
    uniform in [0, 100), floating leaves N(0, 1) x ``scale`` (drawn in the
    leaf's dtype, so a cache takes no more than its own bytes), any other
    dtype zeros."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for leaf in tree_leaves(specs):
        if leaf is None:
            out.append(None)
        elif leaf.dtype.is_floating_point:
            out.append(torch.randn(leaf.shape, generator=gen, device=device,
                                   dtype=leaf.dtype).mul_(scale))
        elif leaf.dtype != torch.bool and not leaf.dtype.is_complex:
            out.append(torch.randint(0, 100, leaf.shape, generator=gen, device=device,
                                     dtype=leaf.dtype))
        else:
            out.append(torch.zeros(leaf.shape, dtype=leaf.dtype, device=device))
    return tree_like(specs, out)
