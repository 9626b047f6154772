"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``, its local path):
top-k routing with a static per-row capacity and argsort-ranked dispatch.

Routing runs in fp32: router logits (B, S, E), the top k experts of each
token, their weights a softmax over the k selected logits
(``moe_router_norm``, qwen3/mixtral) or the full softmax's values at them.
Each (token, choice) pair is ranked within its expert by a stable sort, so
every intermediate is a (B, S·k) integer tensor (a one-hot/cumsum ranking
would hold (B, S·k, E)); a pair whose rank reaches the expert's capacity
C = ceil(1.25·S·k/E) (at least min(S·k, 8), rounded up to 8) is dropped
(GShard/Switch semantics). Dispatch scatters the kept pairs into a
(B, E·C + 1, D) buffer whose last row is the drop slot, the SwiGLU experts
run as batched einsums over (B, E, C, D), and combine gathers each pair's
output back, weighted, and sums a token's k of them. The Switch load
balancing loss E·Σ_e mean-prob_e · routed-share_e takes its counts from a
scatter-add.

The reference's ``sharded_moe`` (expert-parallel dispatch under
``shard_map`` over a device mesh) is mesh-only and not ported: one card
holds every expert, which is the reference's own no-mesh path.

Serving hands the expert weights their adapters unmerged, A (E, D, r) and
B (E, r, F) per group: each expert product is ``einsum(x, W) +
scale·einsum(einsum(x, A), B)`` in plain PyTorch, as the reference computes
the expert products as einsums outside any kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

CAPACITY_FACTOR = 1.25


def init_moe(gen, cfg: ModelConfig, device=None):
    """Router (D, E) in fp32 whatever ``param_dtype`` is; SwiGLU experts
    ``w_gate``/``w_up`` (E, D, F) and ``w_down`` (E, F, D)."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    pd = cfg.param_dtype
    return {
        "router": L.make_param(gen, (D, E), "float32", device=device),
        "w_gate": L.make_param(gen, (E, D, F_), pd, device=device),
        "w_up": L.make_param(gen, (E, D, F_), pd, device=device),
        "w_down": L.make_param(gen, (E, F_, D), pd, scale=0.02 / math.sqrt(2 * cfg.num_layers),
                               device=device),
    }


def expert_capacity(seq_tokens: int, cfg: ModelConfig) -> int:
    """Per-batch-row expert capacity."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    c = int(math.ceil(CAPACITY_FACTOR * seq_tokens * k / E))
    c = max(c, min(seq_tokens * k, 8))
    return ((c + 7) // 8) * 8


def _rank_and_dest(top_e, E: int, C: int, k: int):
    """Rank of each (token, choice) pair within its expert, in token order:
    a stable sort groups equal experts, a running max finds each group's
    start. top_e (b, S, k) -> dest, keep (b, S·k): dest = e·C + rank for a
    kept pair, E·C (the drop slot) for one past the capacity."""
    b, S, _ = top_e.shape
    Sk = S * k
    flat_e = top_e.reshape(b, Sk)
    se, order = torch.sort(flat_e, dim=1, stable=True)
    idx = torch.arange(Sk, device=top_e.device).expand(b, Sk)
    newseg = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=top_e.device),
                        se[:, 1:] != se[:, :-1]], dim=1)
    seg_start = torch.cummax(torch.where(newseg, idx, 0), dim=1).values
    rank = torch.empty_like(flat_e).scatter_(1, order, idx - seg_start)  # back to token order
    keep = rank < C
    dest = torch.where(keep, flat_e * C + rank, E * C)
    return dest, keep


def _dispatch(x, dest, E: int, C: int, k: int):
    """Scatter each kept pair's token into its expert slot: (b, S, D) ->
    (b, E, C, D), empty slots zero; dropped pairs land in the drop slot,
    which is cut off."""
    b, S, D = x.shape
    src = x.repeat_interleave(k, dim=1)  # pair j is token j // k
    buf = x.new_zeros((b, E * C + 1, D))
    buf = buf.scatter(1, dest[..., None].expand(-1, -1, D), src)
    return buf[:, :E * C].reshape(b, E, C, D)


def _combine(ye, dest, keep, w_flat, S: int, k: int):
    """Gather each pair's expert output (the drop slot reads zeros), weight it
    and sum a token's k pairs: (b, E, C, D) -> (b, S, D)."""
    b, E, C, D = ye.shape
    yflat = torch.cat([ye.reshape(b, E * C, D), ye.new_zeros((b, 1, D))], dim=1)
    contrib = yflat.gather(1, dest[..., None].expand(-1, -1, D))  # (b, S·k, D)
    w = (w_flat * keep).to(ye.dtype)
    return torch.sum((contrib * w[..., None]).reshape(b, S, k, D), dim=2)


def _expert_product(xe, w, adapter=None):
    """(b, E, C, d_in) through per-expert weights (E, d_in, d_out), plus the
    adapter's scale·(x·A)·B where one is given as (A, B, scale)."""
    y = torch.einsum("becd,edf->becf", xe, w.to(xe.dtype))
    if adapter is not None:
        a, b, scale = adapter
        xa = torch.einsum("becd,edr->becr", xe, a.to(xe.dtype))
        y = y + scale * torch.einsum("becr,erf->becf", xa, b.to(xe.dtype))
    return y


def _expert_ffn(p, xe, adapters=None):
    """The SwiGLU experts on (b, E, C, D)."""
    ad = adapters or {}
    h = F.silu(_expert_product(xe, p["w_gate"], ad.get("w_gate")))
    h = h * _expert_product(xe, p["w_up"], ad.get("w_up"))
    return _expert_product(h, p["w_down"], ad.get("w_down"))


def route(p, x, cfg: ModelConfig):
    """fp32 routing of x (B, S, D): (top_w, top_e) (B, S, k) and the Switch
    aux loss (a 0-d fp32 tensor)."""
    B, S, _ = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    top_l, top_e = torch.topk(logits, k, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    top_w = torch.softmax(top_l, dim=-1) if cfg.moe_router_norm else probs.gather(-1, top_e)
    me = torch.mean(probs, dim=(0, 1))  # (E,)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, top_e.reshape(-1), torch.ones(B * S * k, dtype=torch.float32, device=x.device))
    aux = E * torch.sum(me * (counts / (B * S * k)))
    return top_w, top_e, aux


def apply_moe(p, x, cfg: ModelConfig, *, adapters=None):
    """x (B, S, D) -> (y (B, S, D), aux loss)."""
    B, S, _ = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = expert_capacity(S, cfg)
    top_w, top_e, aux = route(p, x, cfg)
    dest, keep = _rank_and_dest(top_e, E, C, k)
    ye = _expert_ffn(p, _dispatch(x, dest, E, C, k), adapters)
    y = _combine(ye, dest, keep, top_w.reshape(B, S * k).to(x.dtype), S, k)
    return y, aux
