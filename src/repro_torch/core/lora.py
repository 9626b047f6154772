"""LoRA adapters (port of ``repro/core/lora.py``): w0 + Δw = w0 + A·B·(α/r).

Adapters are keyed by the reference's ``jax.tree_util.keystr`` path of the
weight they adapt, e.g. ``"['groups']['sub_0']['attn']['wq']"``, with the
layer-stack dim kept: ``{"A": (num_groups, d_in, r), "B": (num_groups, r, d_out)}``.

Two ways to apply them, as in the reference:
  * ``merge``      — W' = W + scale·A@B: the training path (autograd through
    the merge gives dA and dB) and the plain serving baseline;
  * ``layer_adapters`` hands each projection its ``(A, B, scale)``, so that
    ``layers.project`` runs the fused LoRA kernel without forming W'
    (serving only: the kernel is forward-only).

``split_client_server`` / ``join_client_server`` cut the adapters at a group
boundary, as the split-learning engine cuts the model.
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
    (Δw = 0 at init), drawn from a generator on ``device`` seeded with ``seed``
    (on the meta device: shapes only)."""
    device = resolve_device(device)
    lcfg = cfg.lora or LoRAConfig()
    r = lcfg.rank
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
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


def delta_norm(lora) -> torch.Tensor:
    """||Δw|| over every adapter's A and B, in fp32 (a 0-d tensor)."""
    sq = [torch.sum(torch.square(v["A"].float())) + torch.sum(torch.square(v["B"].float()))
          for v in lora.values()]
    return torch.sqrt(sum(sq))


def lora_param_count(cfg: ModelConfig) -> int:
    """Adapter parameter count (the delay model's |Δw|), from the shapes of
    ``init_params`` on the meta device: no weights are drawn."""
    from repro_torch.models.transformer import init_params

    lcfg = cfg.lora or LoRAConfig()
    total = 0
    for path, leaf in _leaves(init_params(cfg, device="meta")):
        if path[-1] in lcfg.targets and leaf.ndim >= 2:
            total += leaf.shape[:-2].numel() * lcfg.rank * (leaf.shape[-2] + leaf.shape[-1])
    return total


def split_client_server(lora, cut_group: int):
    """Cut the adapters at a group boundary: leaves under ``groups`` are
    sliced along the group stack (the first ``cut_group`` groups, every
    sub-layer of each, to the client), the encoder's (``enc_groups``, which
    the client runs whole) and embed-side adapters go to the client, the
    rest (tail layers) to the server. (The reference slices ``enc_groups``
    at ``cut_group`` too, as if it were the decoder's stack: the client's
    encoder then broadcasts its first ``cut_group`` layers' adapters over
    every encoder layer, and the server's are never used.)"""
    client, server = {}, {}
    for pstr, ab in lora.items():
        if pstr.startswith("['enc_groups']"):
            client[pstr] = ab
        elif "groups" in pstr:
            client[pstr] = {k: v[:cut_group] for k, v in ab.items()}
            server[pstr] = {k: v[cut_group:] for k, v in ab.items()}
        elif "embed" in pstr:
            client[pstr] = ab
        else:
            server[pstr] = ab
    return client, server


def join_client_server(client, server):
    """Inverse of ``split_client_server``."""
    out = {}
    for pstr in list(client) + [p for p in server if p not in client]:
        if pstr in client and pstr in server:
            out[pstr] = {k: torch.cat([client[pstr][k], server[pstr][k]], dim=0)
                         for k in client[pstr]}
        else:
            out[pstr] = client[pstr] if pstr in client else server[pstr]
    return out


def layer_adapters(lora, cfg: ModelConfig, index, top: str = "groups"):
    """The adapters of group ``index`` of the stack ``params[top]``
    (``groups``, or the encoder's ``enc_groups``), or, with ``index=None``,
    of the unstacked layer ``params[top]``, a tail layer ``tail_<i>``, as a
    nested dict mirroring that group's or layer's parameters, each leaf
    ``(A, B, scale)``."""
    scale = (cfg.lora or LoRAConfig()).scale
    out: dict = {}
    for pstr, ab in (lora or {}).items():
        first, *path = _KEY.findall(pstr)
        if first not in ("groups", "enc_groups") and not first.startswith("tail_"):
            raise NotImplementedError(f"adapter outside the layer stack: {pstr}")
        if first != top:
            continue
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        a, b = (ab["A"], ab["B"]) if index is None else (ab["A"][index], ab["B"][index])
        node[path[-1]] = (a, b, scale)
    return out
