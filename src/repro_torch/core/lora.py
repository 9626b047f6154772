"""LoRA adapters (port of ``repro/core/lora.py``): w0 + Δw = w0 + A·B·(α/r).

Adapters are keyed by the reference's ``jax.tree_util.keystr`` path of the
weight they adapt, e.g. ``"['groups']['sub_0']['attn']['wq']"``, with the
layer-stack dim kept: ``{"A": (num_groups, d_in, r), "B": (num_groups, r, d_out)}``.

Two ways to apply them, as in the reference:
  * ``merge``      — W' = W + scale·A@B, the plain baseline;
  * ``layer_adapters`` hands each projection its ``(A, B, scale)``, so that
    ``layers.project`` runs the fused LoRA kernel without forming W'.
"""

from __future__ import annotations

import re

import torch

from repro_torch.config import LoRAConfig, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import torch_dtype

_KEY = re.compile(r"\['([^']*)'\]")


def keystr(path) -> str:
    """The reference's key string of a path of dict keys."""
    return "".join(f"['{k}']" for k in path)


def _leaves(tree, path=()):
    """(path, tensor) pairs of a nested dict, in sorted key order (JAX's order)."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def init_lora(params, cfg: ModelConfig, seed: int = 1, device="cuda"):
    """Adapters for every targeted weight of ``params``: A ~ N(0,1)/r, B = 0
    (Δw = 0 at init), drawn from a generator on ``device`` seeded with ``seed``."""
    device = resolve_device(device)
    lcfg = cfg.lora or LoRAConfig()
    r = lcfg.rank
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = torch_dtype(cfg.param_dtype)
    out = {}
    for path, leaf in _leaves(params):
        if path[-1] not in lcfg.targets or leaf.ndim < 2:
            continue
        lead, (d_in, d_out) = tuple(leaf.shape[:-2]), leaf.shape[-2:]
        a = torch.randn(lead + (d_in, r), generator=gen, dtype=torch.float32, device=device) / r
        out[keystr(path)] = {"A": a.to(dtype),
                             "B": torch.zeros(lead + (r, d_out), dtype=dtype, device=device)}
    return out


def merge(params, lora, cfg: ModelConfig):
    """W' = W + scale·A@B at every adapted leaf (fp32, cast to W's dtype)."""
    scale = (cfg.lora or LoRAConfig()).scale

    def walk(tree, path):
        out = {}
        for key, value in tree.items():
            p = path + (key,)
            if isinstance(value, dict):
                out[key] = walk(value, p)
            elif keystr(p) in lora:
                ab = lora[keystr(p)]
                delta = torch.einsum("...ir,...ro->...io", ab["A"].float(), ab["B"].float())
                out[key] = (value.float() + delta * scale).to(value.dtype)
            else:
                out[key] = value
        return out

    return walk(params, ())


def layer_adapters(lora, cfg: ModelConfig, index: int):
    """The adapters of layer ``index`` of the stack ``params["groups"]``, as a
    nested dict mirroring that layer's parameters, each leaf
    ``(A[index], B[index], scale)``."""
    scale = (cfg.lora or LoRAConfig()).scale
    out: dict = {}
    for pstr, ab in (lora or {}).items():
        top, *path = _KEY.findall(pstr)
        if top != "groups":
            raise NotImplementedError(f"adapter outside the layer stack: {pstr}")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (ab["A"][index], ab["B"][index], scale)
    return out
