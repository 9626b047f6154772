"""Decoder stack (port of ``repro/models/transformer.py``) for two of the
reference's layer chars: ``G`` (global attention + MLP, the ``dense`` family)
and ``M`` (a Mamba-2 SSD block, the ``ssm`` family). One char per group.

Parameters keep the reference's tree: ``{"embed", "groups", "final_norm"}``
with the group leaves stacked ``(num_groups, ...)``; the reference's
``lax.scan`` over groups is a Python loop here, over whatever stack it is
given (the whole stack, or the split engine's client or server view), and
the caches (KV ``(num_groups, B, S, Kv, hd)``; SSM conv and SSD states) are
updated in place (the reference carries a new cache through the scan; in
place saves a cache copy per step).

Two paths, as in the reference:
  * training (``hidden_states``, ``loss_fn`` and ``core/split.py``) runs
    merged weights (``lora.merge``), ``_attend_full`` and ``ssd_chunked``
    under autograd, and no kernel: the kernels are forward-only;
  * serving (``prefill``, ``decode_step``) takes the adapters unmerged:
    adapted projections run the fused LoRA kernel, and ``kernels`` (prefill
    only) picks the CUDA kernels of flash attention and the SSD scan or
    their plain baselines ``_attend_full`` and ``ssd_chunked``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.core.lora import layer_adapters
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2

# (family, layer_pattern) pairs the port runs
PORTED = {("dense", "G"), ("ssm", "M")}


def _require_ported(cfg: ModelConfig) -> None:
    unported = {"family/layer_pattern": (cfg.family, cfg.layer_pattern) not in PORTED,
                "qk_norm": cfg.qk_norm, "use_bias": cfg.use_bias,
                "use_post_norm": cfg.use_post_norm, "parallel_block": cfg.parallel_block,
                "num_experts": bool(cfg.num_experts)}
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.name}: not ported yet ({', '.join(bad)}); the port runs "
                                  "the dense family with layer_pattern 'G' and the ssm family "
                                  "with layer_pattern 'M'")


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
    if cfg.layer_pattern == "M":
        return {"norm1": L.init_norm(gen, cfg, cfg.d_model, device),
                "mamba": M2.init_mamba(gen, cfg, device)}
    return {"norm1": L.init_norm(gen, cfg, cfg.d_model, device),
            "attn": L.init_attn(gen, cfg, device),
            "norm2": L.init_norm(gen, cfg, cfg.d_model, device),
            "mlp": L.init_mlp(gen, cfg, device)}


def apply_sublayer(p, x, cfg: ModelConfig, *, cache=None, cache_pos=None, positions=None,
                   adapters=None, kernels=True):
    """One pre-norm layer: the reference's ``G`` or ``M`` branch."""
    ad = adapters or {}
    h = L.apply_norm(p["norm1"], x, cfg)
    if cfg.layer_pattern == "M":
        return x + M2.apply_mamba(p["mamba"], h, cfg, cache["ssm"] if cache else None,
                                  adapters=ad.get("mamba"), kernels=kernels)
    x = x + L.attention(p["attn"], h, cfg, adapters=ad.get("attn"), positions=positions,
                        cache=cache["attn"] if cache else None, cache_pos=cache_pos,
                        kernels=kernels)
    h2 = L.apply_norm(p["norm2"], x, cfg)
    return x + L.apply_mlp(p["mlp"], h2, cfg, adapters=ad.get("mlp"))


def apply_group(gp, x, cfg: ModelConfig, *, cache=None, cache_pos=None, positions=None,
                adapters=None, kernels=True):
    ad = adapters or {}
    return apply_sublayer(gp["sub_0"], x, cfg, cache=cache["sub_0"] if cache else None,
                          cache_pos=cache_pos, positions=positions, adapters=ad.get("sub_0"),
                          kernels=kernels)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random weights with the reference's shapes and scales, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (on the meta
    device: shapes only)."""
    _require_ported(cfg)
    device = resolve_device(device)
    # the meta device holds shapes only (lora_param_count): nothing to draw
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
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


def _num_groups(groups) -> int:
    while isinstance(groups, dict):
        groups = next(iter(groups.values()))
    return groups.shape[0]


def _scan_groups(params, x, cfg: ModelConfig, *, cache=None, cache_pos=None, positions=None,
                 lora=None, kernels=True, remat=False):
    """Run the stacked groups ``params["groups"]``, writing the cache (if any)
    in place. The stack may be a view of the model's (``groups[:cut]`` or
    ``groups[cut:]``), with ``lora`` cut to the same layers
    (``lora.split_client_server``). The ported patterns are one char long, so
    no model has the reference's tail layers. ``remat``: each group's
    activations are recomputed in the backward pass instead of kept
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` per
    group); the values and gradients are the same."""
    _require_ported(cfg)
    for i in range(_num_groups(params["groups"])):
        def group(h, i=i):
            return apply_group(_index(params["groups"], i), h, cfg,
                               cache=_index(cache["groups"], i) if cache else None,
                               cache_pos=cache_pos, positions=positions,
                               adapters=layer_adapters(lora, cfg, i), kernels=kernels)

        x = checkpoint(group, x, use_reentrant=False) if remat else group(x)
    return x


def forward(params, batch, cfg: ModelConfig, *, lora=None, kernels=True):
    """Full forward -> logits (B, S, V), fp32."""
    x, positions = _embed_inputs(params, batch, cfg)
    x = _scan_groups(params, x, cfg, positions=positions, lora=lora, kernels=kernels)
    return L.lm_logits(params["embed"], L.apply_norm(params["final_norm"], x, cfg), cfg)


def hidden_states(params, batch, cfg: ModelConfig, *, remat: bool = False,
                  unroll: bool = False):
    """The training path's forward up to the final norm. Returns (x, aux);
    aux = 0, since no ported family has the reference's MoE aux loss.
    ``remat`` recomputes each group's activations in the backward pass
    (``_scan_groups``); ``unroll`` is the reference's ``lax.scan`` unrolling,
    which a Python loop has no use for: it is taken and ignored."""
    x, positions = _embed_inputs(params, batch, cfg)
    x = _scan_groups(params, x, cfg, positions=positions, kernels=False, remat=remat)
    return L.apply_norm(params["final_norm"], x, cfg), x.new_zeros((), dtype=torch.float32)


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = False, aux_weight=0.01,
            unroll: bool = False):
    """Training loss: sequence-chunked CE (``layers.fused_cross_entropy``) +
    aux_weight·aux. Returns (loss, {"ce_loss", "moe_aux"}). ``remat`` and
    ``unroll`` as in ``hidden_states``."""
    x, aux = hidden_states(params, batch, cfg, remat=remat)
    loss = L.fused_cross_entropy(params["embed"], x, batch["labels"], cfg,
                                 mask=batch.get("mask"))
    return loss + aux_weight * aux, {"ce_loss": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device="cuda"):
    """Zero cache ``{"groups": {"sub_0": ...}}`` with the layer stack leading:
    ``{"attn": (k, v)}``, each ``(num_groups, B, max_seq, Kv, hd)``, for
    ``G``; ``{"ssm": (conv_state, ssd_state)}`` for ``M`` (``max_seq`` unused:
    the state does not grow)."""
    _require_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or L.torch_dtype(cfg.dtype)
    ng = cfg.num_layers
    if cfg.layer_pattern == "M":
        conv, ssd = M2.init_mamba_cache(cfg, batch, dtype, device)
        return {"groups": {"sub_0": {"ssm": (conv.new_zeros((ng,) + conv.shape),
                                             ssd.new_zeros((ng,) + ssd.shape))}}}
    shape = (ng, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
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


def prefill(params, batch, cfg: ModelConfig, cache, *, lora=None, kernels=True):
    """Prefill: run the full prompt, writing the cache. Returns (logits, cache)."""
    x, positions = _embed_inputs(params, batch, cfg)
    x = _scan_groups(params, x, cfg, cache=cache, cache_pos=0, positions=positions,
                     lora=lora, kernels=kernels)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x, cfg), cache
