"""Dense decoder stack (port of ``repro/models/transformer.py``, the ``dense``
family with ``layer_pattern="G"`` only: one global-attention layer per group).

Parameters keep the reference's tree: ``{"embed", "groups", "final_norm"}``
with the group leaves stacked ``(num_groups, ...)``; the reference's
``lax.scan`` over groups is a Python loop here, and the KV cache
``(num_groups, B, S, Kv, hd)`` is updated in place (the reference carries a
new cache through the scan; in place saves a cache copy per step).
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.lora import layer_adapters
from repro_torch.models import layers as L


def _require_dense(cfg: ModelConfig) -> None:
    unported = {"family": cfg.family != "dense", "layer_pattern": cfg.layer_pattern != "G",
                "qk_norm": cfg.qk_norm, "use_bias": cfg.use_bias,
                "use_post_norm": cfg.use_post_norm, "parallel_block": cfg.parallel_block,
                "num_experts": bool(cfg.num_experts)}
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.name}: not ported yet ({', '.join(bad)}); "
                                  "the port runs the dense family with layer_pattern 'G'")


def _index(tree, i):
    """Slice i of every stacked leaf (views, so in-place cache writes land)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, i) for v in tree)
    return tree[i]


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def init_sublayer(gen, cfg: ModelConfig, device=None):
    return {"norm1": L.init_norm(gen, cfg, cfg.d_model, device),
            "attn": L.init_attn(gen, cfg, device),
            "norm2": L.init_norm(gen, cfg, cfg.d_model, device),
            "mlp": L.init_mlp(gen, cfg, device)}


def apply_sublayer(p, x, cfg: ModelConfig, *, cache=None, cache_pos=None, positions=None,
                   adapters=None, flash=True):
    """One pre-norm layer (the reference's ``G`` branch)."""
    ad = adapters or {}
    h = L.apply_norm(p["norm1"], x, cfg)
    x = x + L.attention(p["attn"], h, cfg, adapters=ad.get("attn"), positions=positions,
                        cache=cache["attn"] if cache else None, cache_pos=cache_pos,
                        flash=flash)
    h2 = L.apply_norm(p["norm2"], x, cfg)
    return x + L.apply_mlp(p["mlp"], h2, cfg, adapters=ad.get("mlp"))


def apply_group(gp, x, cfg: ModelConfig, *, cache=None, cache_pos=None, positions=None,
                adapters=None, flash=True):
    ad = adapters or {}
    return apply_sublayer(gp["sub_0"], x, cfg, cache=cache["sub_0"] if cache else None,
                          cache_pos=cache_pos, positions=positions, adapters=ad.get("sub_0"),
                          flash=flash)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights with the reference's shapes and scales, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    _require_dense(cfg)
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    tree = {"embed": L.init_embed(gen, cfg, device)}
    layers = [init_sublayer(gen, cfg, device) for _ in range(cfg.num_layers)]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(g[k] for g in leaves)) for k in leaves[0]}
        return torch.stack(leaves)

    tree["groups"] = {"sub_0": stack(*layers)}
    tree["final_norm"] = L.init_norm(gen, cfg, cfg.d_model, device)
    return tree


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embedding. Returns (x, positions)."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return x, positions


def _scan_groups(params, x, cfg: ModelConfig, *, cache=None, cache_pos=None, positions=None,
                 lora=None, flash=True):
    """Run the stacked groups, writing the cache (if any) in place."""
    _require_dense(cfg)
    for i in range(cfg.num_layers):
        x = apply_group(_index(params["groups"], i), x, cfg,
                        cache=_index(cache["groups"], i) if cache else None,
                        cache_pos=cache_pos, positions=positions,
                        adapters=layer_adapters(lora, cfg, i), flash=flash)
    return x


def forward(params, batch, cfg: ModelConfig, *, lora=None, flash=True):
    """Full forward -> logits (B, S, V), fp32."""
    x, positions = _embed_inputs(params, batch, cfg)
    x = _scan_groups(params, x, cfg, positions=positions, lora=lora, flash=flash)
    return L.lm_logits(params["embed"], L.apply_norm(params["final_norm"], x, cfg), cfg)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device=None):
    """Zero KV cache ``{"groups": {"sub_0": {"attn": (k, v)}}}``, k and v each
    ``(num_groups, B, max_seq, Kv, hd)``."""
    _require_dense(cfg)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    dtype = dtype or L.torch_dtype(cfg.dtype)
    kv = tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(2))
    return {"groups": {"sub_0": {"attn": kv}}}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def decode_step(params, tokens, cache, cache_pos: int, cfg: ModelConfig, *, lora=None):
    """One-token decode. tokens: (B, 1). Returns (logits (B,1,V), cache)."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    positions = torch.full((tokens.shape[0], 1), cache_pos, dtype=torch.int64,
                           device=tokens.device)
    x = _scan_groups(params, x, cfg, cache=cache, cache_pos=cache_pos, positions=positions,
                     lora=lora)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x, cfg), cache


def prefill(params, batch, cfg: ModelConfig, cache, *, lora=None, flash=True):
    """Prefill: run the full prompt, writing the cache. Returns (logits, cache)."""
    x, positions = _embed_inputs(params, batch, cfg)
    x = _scan_groups(params, x, cfg, cache=cache, cache_pos=0, positions=positions,
                     lora=lora, flash=flash)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x, cfg), cache
