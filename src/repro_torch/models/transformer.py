"""Model stack (port of ``repro/models/transformer.py``) for four of the
reference's layer chars: ``G`` (global attention + MLP or MoE) and ``L``
(sliding-window attention + MLP), ``M`` (a Mamba-2 SSD block) and ``R`` (an
RG-LRU recurrent block + MLP). The families it runs: ``dense`` (layer
patterns ``G`` and ``LG``), ``moe`` (``G`` with a routed expert FFN and,
for olmoe/qwen3, ``qk_norm``), ``ssm`` (``M``), ``hybrid`` (``RRL``),
``encdec`` (whisper: a non-causal encoder stack ``enc_groups`` over stub
frame embeddings, learned positions, and decoder layers that cross-attend
to the encoder's output) and ``vlm`` (llava: stub patch embeddings through
a two-layer projector, put in front of the tokens).

Parameters keep the reference's tree: ``{"embed", "groups", "final_norm"}``
(plus ``tail_<i>`` layers where the depth is not a multiple of the pattern;
``enc_groups``, ``enc_final_norm``, ``enc_pos`` and ``dec_pos`` for
``encdec``; ``projector`` for ``vlm``),
where a group is one copy of the layer pattern, ``{"sub_0": ..., "sub_1":
...}``, and its leaves are stacked ``(num_groups, ...)``. The reference's
``lax.scan`` over groups is a Python loop here, over whatever stack it is
given (the whole stack, or the split engine's client or server view), and
the caches (KV ``(num_groups, B, S_c, Kv, hd)``, with S_c the window for
``L`` layers; an ``encdec`` layer's ``cross`` keys and values (B,
encoder_seq, Kv, hd); SSM conv and SSD states; RG-LRU conv and h states) are
updated in place (the reference carries a new cache through the scan; in
place saves a cache copy per step).

Two paths, as in the reference:
  * training (``hidden_states``, ``loss_fn`` and ``core/split.py``) runs
    merged weights (``lora.merge``), the plain attentions and
    ``ssd_chunked`` under autograd, and no kernel: the kernels are
    forward-only; the MoE layers' load-balancing aux loss is summed over
    the layers and added to the loss with ``aux_weight``;
  * serving (``prefill``, ``decode_step``) takes the adapters unmerged:
    adapted 2-D projections run the fused LoRA kernel (the experts' stacked
    products run as einsums, ``models/moe.py``), and ``kernels`` (prefill
    only) picks the CUDA kernels of flash attention and the SSD scan or
    their plain baselines.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.core.lora import layer_adapters
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.tree import tree_map

# (family, layer_pattern) pairs the port runs
PORTED = {("dense", "G"), ("dense", "LG"), ("moe", "G"), ("ssm", "M"), ("hybrid", "RRL"),
          ("encdec", "G"), ("vlm", "G")}
LONG_PREFILL, Q_CHUNK = 16384, 2048  # the reference's query chunking of long sequences
VISION_WIDTH = 1024  # vlm: the vision encoder's width (CLIP-L); the frontend is a stub
DEC_POSITIONS = 32768  # encdec: the decoder's learned positions


def _require_ported(cfg: ModelConfig) -> None:
    if (cfg.family, cfg.layer_pattern) not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet (family {cfg.family!r}, layer_pattern "
            f"{cfg.layer_pattern!r}); the port runs " + ", ".join(
                f"{f} with {lp!r}" for f, lp in sorted(PORTED)))


def _slices(tree) -> list:
    """The per-group trees of a stacked tree: every leaf unbound along its
    first dim once (views, so in-place cache writes land). Under autograd
    one unbind stacks the groups' gradients once; indexing the stack group
    by group would zero-fill and add a whole-stack gradient for every group
    (memory traffic growing with depth squared)."""
    if isinstance(tree, dict):
        parts = {k: _slices(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, tuple):
        parts = [_slices(v) for v in tree]
        return [tuple(p[i] for p in parts) for i in range(len(parts[0]))]
    return list(torch.unbind(tree))


# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------


def group_chars(cfg: ModelConfig) -> str:
    return cfg.layer_pattern


def n_full_groups(cfg: ModelConfig) -> int:
    return cfg.num_layers // len(cfg.layer_pattern)


def tail_chars(cfg: ModelConfig) -> str:
    return cfg.layer_pattern[:cfg.num_layers % len(cfg.layer_pattern)]


def _char_window(cfg: ModelConfig, ch: str) -> int:
    return cfg.sliding_window if ch == "L" else 0


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def init_sublayer(gen, cfg: ModelConfig, ch: str, device=None, cross_attn: bool = False):
    p = {"norm1": L.init_norm(gen, cfg, cfg.d_model, device)}
    if ch == "M":
        p["mamba"] = M2.init_mamba(gen, cfg, device)
        return p
    if ch == "R":
        p["rglru"] = RG.init_rglru_block(gen, cfg, device)
        p["norm2"] = L.init_norm(gen, cfg, cfg.d_model, device)
        p["mlp"] = L.init_mlp(gen, cfg, device)
        return p
    if ch not in ("G", "L"):
        raise ValueError(ch)
    p["attn"] = L.init_attn(gen, cfg, device)
    if cross_attn:
        p["norm_x"] = L.init_norm(gen, cfg, cfg.d_model, device)
        p["xattn"] = L.init_attn(gen, cfg, device)
    if not cfg.parallel_block:
        p["norm2"] = L.init_norm(gen, cfg, cfg.d_model, device)
    if cfg.use_post_norm:
        p["post_norm1"] = L.init_norm(gen, cfg, cfg.d_model, device)
        p["post_norm2"] = L.init_norm(gen, cfg, cfg.d_model, device)
    if cfg.num_experts:
        p["moe"] = MOE.init_moe(gen, cfg, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, device)
    return p


def _ffn(p, h, cfg: ModelConfig, ad):
    """The MLP, or the MoE layer: (out, aux loss or None)."""
    if "moe" in p:
        return MOE.apply_moe(p["moe"], h, cfg, adapters=ad.get("moe"))
    return L.apply_mlp(p["mlp"], h, cfg, adapters=ad.get("mlp")), None


def _cross_attention(p, x, enc_out, cfg: ModelConfig, cache, *, adapters=None,
                     kernels=True):
    """The reference's ``_cross_attention``: q from the decoder's ``x``, k/v
    from the encoder's output ``enc_out`` (B, encoder_seq, D), non-causal,
    without RoPE and without the ``xattn`` biases (the reference makes and
    counts them but never adds them). k/v are projected from ``enc_out``
    whenever it is given, at any prompt length, and written into the
    ``cross`` cache (if any), which the flash kernel then reads; a decode
    step passes no ``enc_out`` and reads them from that cache. (The
    reference takes the cache whenever x holds one token, so a one-token
    prompt's prefill reads the zero cache and never fills it.) A prompt of
    more than one token runs flash (``kernels``) or ``_attend_full``; a
    single token ``_attend_full``, as self-attention's decode is plain."""
    B, S, _ = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ad = adapters or {}
    q = L.project(x, p["wq"], ad.get("wq")).reshape(B, S, H, hd)
    if enc_out is None:
        if cache is None:
            raise ValueError("cross-attention needs the encoder's output or a filled cross cache")
        k, v = (c.to(q.dtype) for c in cache)
    else:
        Se = enc_out.shape[1]
        k = L.project(enc_out, p["wk"], ad.get("wk")).reshape(B, Se, Kv, hd)
        v = L.project(enc_out, p["wv"], ad.get("wv")).reshape(B, Se, Kv, hd)
        if cache is not None:
            cache[0].copy_(k)
            cache[1].copy_(v)
            if cache[0].dtype == k.dtype:
                k, v = cache
    if kernels and S > 1:
        out = L._attend_flash(q, k, v, causal=False, window=0, softcap=0.0)
    else:
        out = L._attend_full(q, k, v, causal=False, window=0, softcap=0.0)
    return L.project(out, p["wo"], ad.get("wo"))


def apply_sublayer(p, x, cfg: ModelConfig, ch: str, *, cache=None, cache_pos=None,
                   positions=None, adapters=None, kernels=True, q_chunk=0, causal=True,
                   enc_out=None):
    """One pre-norm layer: the reference's ``G``/``L`` branch (with its post
    norms, parallel block, MoE and, in an ``encdec`` decoder layer, the
    cross-attention to ``enc_out`` or to the ``cross`` cache), its ``M``
    branch or its ``R`` branch. ``causal=False``: an encoder layer.
    Returns (x, aux): the MoE layer's aux loss, None for any other layer."""
    ad = adapters or {}
    h = L.apply_norm(p["norm1"], x, cfg)
    if ch == "M":
        return x + M2.apply_mamba(p["mamba"], h, cfg, cache["ssm"] if cache else None,
                                  adapters=ad.get("mamba"), kernels=kernels), None
    if ch == "R":
        x = x + RG.apply_rglru_block(p["rglru"], h, cfg, cache["rec"] if cache else None,
                                     adapters=ad.get("rglru"))
        return x + L.apply_mlp(p["mlp"], L.apply_norm(p["norm2"], x, cfg), cfg,
                               adapters=ad.get("mlp")), None
    a = L.attention(p["attn"], h, cfg, window=_char_window(cfg, ch), adapters=ad.get("attn"),
                    positions=positions, cache=cache["attn"] if cache else None,
                    cache_pos=cache_pos, kernels=kernels, q_chunk=q_chunk, causal=causal)
    if cfg.use_post_norm:
        a = L.apply_norm(p["post_norm1"], a, cfg)
    if cfg.parallel_block:  # attention and MLP both read norm1's output
        m, aux = _ffn(p, h, cfg, ad)
        return x + a + m, aux
    x = x + a
    if "xattn" in p:
        x = x + _cross_attention(p["xattn"], L.apply_norm(p["norm_x"], x, cfg), enc_out, cfg,
                                 cache["cross"] if cache else None, adapters=ad.get("xattn"),
                                 kernels=kernels)
    m, aux = _ffn(p, L.apply_norm(p["norm2"], x, cfg), cfg, ad)
    if cfg.use_post_norm:
        m = L.apply_norm(p["post_norm2"], m, cfg)
    return x + m, aux


def _add_aux(total, aux):
    return total if aux is None else aux if total is None else total + aux


def apply_group(gp, x, cfg: ModelConfig, *, cache=None, cache_pos=None, positions=None,
                adapters=None, kernels=True, q_chunk=0, causal=True, enc_out=None):
    """One copy of the layer pattern: sub-layer ``sub_<i>`` for char i.
    Returns (x, the group's summed aux loss or None)."""
    ad = adapters or {}
    aux = None
    for i, ch in enumerate(group_chars(cfg)):
        key = f"sub_{i}"
        x, a = apply_sublayer(gp[key], x, cfg, ch, cache=cache[key] if cache else None,
                              cache_pos=cache_pos, positions=positions, adapters=ad.get(key),
                              kernels=kernels, q_chunk=q_chunk, causal=causal, enc_out=enc_out)
        aux = _add_aux(aux, a)
    return x, aux


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _stack(groups):
    return tree_map(lambda *leaves: torch.stack(leaves), *groups)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random weights with the reference's shapes and scales, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (on the meta
    device: shapes only)."""
    _require_ported(cfg)
    device = resolve_device(device)
    # the meta device holds shapes only (lora_param_count): nothing to draw
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    cross = cfg.family == "encdec"
    D, dt = cfg.d_model, cfg.param_dtype
    tree = {"embed": L.init_embed(gen, cfg, device)}
    tree["groups"] = _stack([{f"sub_{i}": init_sublayer(gen, cfg, ch, device, cross)
                              for i, ch in enumerate(group_chars(cfg))}
                             for _ in range(n_full_groups(cfg))])
    for i, ch in enumerate(tail_chars(cfg)):
        tree[f"tail_{i}"] = init_sublayer(gen, cfg, ch, device, cross)
    tree["final_norm"] = L.init_norm(gen, cfg, D, device)
    if cross:
        tree["enc_groups"] = _stack([{"sub_0": init_sublayer(gen, cfg, "G", device)}
                                     for _ in range(cfg.num_encoder_layers)])
        tree["enc_final_norm"] = L.init_norm(gen, cfg, D, device)
        # learned positions (whisper's)
        tree["enc_pos"] = L.make_param(gen, (cfg.encoder_seq, D), dt, device=device)
        tree["dec_pos"] = L.make_param(gen, (DEC_POSITIONS, D), dt, device=device)
    if cfg.family == "vlm":
        tree["projector"] = {
            "w1": L.make_param(gen, (VISION_WIDTH, D), dt, device=device),
            "b1": L.make_param(gen, (D,), dt, init="zeros", device=device),
            "w2": L.make_param(gen, (D, D), dt, device=device),
            "b2": L.make_param(gen, (D,), dt, init="zeros", device=device),
        }
    return tree


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embedding; for ``vlm`` the stub ``vision_embeds`` (B, Tv, 1024)
    projected (two products with biases, tanh GELU between) and put in
    front of the tokens, so positions count Tv + S; for ``encdec`` the
    decoder's learned positions added. Returns (x, positions)."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        pj = params["projector"]
        v = batch["vision_embeds"].to(L.torch_dtype(cfg.dtype))
        v = F.gelu(v @ pj["w1"].to(v.dtype) + pj["b1"], approximate="tanh")
        x = torch.cat([v @ pj["w2"].to(v.dtype) + pj["b2"], x], dim=1)
    S = x.shape[1]
    if cfg.family == "encdec":
        x = x + params["dec_pos"][None, :S].to(x.dtype)
    return x, torch.arange(S, device=x.device)[None, :]


def _run_encoder(params, batch, cfg: ModelConfig, *, lora=None, kernels=True):
    """The encoder (``encdec``): the stub ``frame_embeds`` (B, Se, D) plus
    the learned ``enc_pos``, then the ``enc_groups`` stack, non-causal and
    without RoPE (flash with ``kernels``; the adapters of ``enc_groups``
    through the fused LoRA kernel), then ``enc_final_norm``."""
    frames = batch["frame_embeds"].to(L.torch_dtype(cfg.dtype))
    x = frames + params["enc_pos"][None, :frames.shape[1]].to(frames.dtype)
    ecfg = cfg.replace(layer_pattern="G", use_rope=False)
    for i, gp in enumerate(_slices(params["enc_groups"])):
        x, _ = apply_group(gp, x, ecfg, adapters=layer_adapters(lora, cfg, i, top="enc_groups"),
                           kernels=kernels, causal=False)
    return L.apply_norm(params["enc_final_norm"], x, cfg)


def _encode(params, batch, cfg: ModelConfig, **kw):
    """``_run_encoder``'s output for ``encdec``, else None."""
    return _run_encoder(params, batch, cfg, **kw) if cfg.family == "encdec" else None


def _q_chunk(S: int) -> int:
    return Q_CHUNK if S >= LONG_PREFILL else 0


def _scan_groups(params, x, cfg: ModelConfig, *, cache=None, cache_pos=None, positions=None,
                 lora=None, kernels=True, remat=False, q_chunk=0, include_tail=True,
                 enc_out=None):
    """Run the stacked groups ``params["groups"]`` and then (``include_tail``)
    the tail layers, writing the cache (if any) in place; ``encdec`` layers
    cross-attend to ``enc_out`` (or, None, to their ``cross`` cache). The stack may be a
    view of the model's (``groups[:cut]`` or ``groups[cut:]``), with
    ``lora`` cut to the same groups (``lora.split_client_server``); the
    client's side runs no tail. ``remat``: each group's activations are
    recomputed in the backward pass instead of kept
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` per
    group); the values and gradients are the same. Returns (x, aux): the
    MoE layers' aux losses summed, a 0-d fp32 tensor (0 without MoE)."""
    _require_ported(cfg)
    groups = _slices(params["groups"])
    caches = _slices(cache["groups"]) if cache else [None] * len(groups)
    aux = None
    for i, (gp, gc) in enumerate(zip(groups, caches)):
        def group(h, i=i, gp=gp, gc=gc):
            return apply_group(gp, h, cfg, cache=gc, cache_pos=cache_pos, positions=positions,
                               adapters=layer_adapters(lora, cfg, i), kernels=kernels,
                               q_chunk=q_chunk, enc_out=enc_out)

        x, a = checkpoint(group, x, use_reentrant=False) if remat else group(x)
        aux = _add_aux(aux, a)
    for i, ch in enumerate(tail_chars(cfg) if include_tail else ""):
        key = f"tail_{i}"
        x, a = apply_sublayer(params[key], x, cfg, ch, cache=cache[key] if cache else None,
                              cache_pos=cache_pos, positions=positions,
                              adapters=layer_adapters(lora, cfg, None, top=key),
                              kernels=kernels, q_chunk=q_chunk, enc_out=enc_out)
        aux = _add_aux(aux, a)
    return x, (x.new_zeros((), dtype=torch.float32) if aux is None else aux)


def forward(params, batch, cfg: ModelConfig, *, lora=None, kernels=True):
    """Full forward -> logits (B, S, V), fp32 (vlm: S counts the Tv patches)."""
    enc_out = _encode(params, batch, cfg, lora=lora, kernels=kernels)
    x, positions = _embed_inputs(params, batch, cfg)
    x, _ = _scan_groups(params, x, cfg, positions=positions, lora=lora, kernels=kernels,
                        q_chunk=_q_chunk(x.shape[1]), enc_out=enc_out)
    return L.lm_logits(params["embed"], L.apply_norm(params["final_norm"], x, cfg), cfg)


def hidden_states(params, batch, cfg: ModelConfig, *, remat: bool = False,
                  unroll: bool = False):
    """The training path's forward up to the final norm. Returns (x, aux),
    aux the MoE layers' load-balancing losses summed over the layers (0
    without MoE). ``remat`` recomputes each group's activations in the
    backward pass (``_scan_groups``); ``unroll`` is the reference's
    ``lax.scan`` unrolling, which a Python loop has no use for: it is taken
    and ignored."""
    enc_out = _encode(params, batch, cfg, kernels=False)
    x, positions = _embed_inputs(params, batch, cfg)
    x, aux = _scan_groups(params, x, cfg, positions=positions, kernels=False, remat=remat,
                          q_chunk=_q_chunk(x.shape[1]), enc_out=enc_out)
    return L.apply_norm(params["final_norm"], x, cfg), aux


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = False, aux_weight=0.01,
            unroll: bool = False):
    """Training loss: sequence-chunked CE (``layers.fused_cross_entropy``) +
    aux_weight·aux (``hidden_states``' MoE aux loss). Returns (loss, {"ce_loss", "moe_aux"}). ``remat`` and
    ``unroll`` as in ``hidden_states``."""
    x, aux = hidden_states(params, batch, cfg, remat=remat)
    loss = L.fused_cross_entropy(params["embed"], x, batch["labels"], cfg,
                                 mask=batch.get("mask"))
    return loss + aux_weight * aux, {"ce_loss": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def _sublayer_cache(cfg: ModelConfig, ch: str, batch: int, max_seq: int, dtype, device,
                    cross: bool = False):
    """``{"attn": (k, v)}``, each (B, S_c, Kv, hd) with S_c = min(window,
    max_seq) for ``L`` (a ring buffer once S_c == window) and max_seq for
    ``G``, and with ``cross`` the cross-attention's ``{"cross": (k, v)}``,
    each (B, encoder_seq, Kv, hd); ``{"ssm": (conv_state, ssd_state)}`` for
    ``M``; ``{"rec": (conv_state, h)}`` for ``R``."""
    if ch == "M":
        return {"ssm": M2.init_mamba_cache(cfg, batch, dtype, device)}
    if ch == "R":
        return {"rec": RG.init_rglru_cache(cfg, batch, dtype, device)}
    window = _char_window(cfg, ch)
    S_c = min(window, max_seq) if window else max_seq
    kv = {"attn": S_c, "cross": cfg.encoder_seq} if cross else {"attn": S_c}
    return {key: tuple(torch.zeros((batch, n, cfg.num_kv_heads, cfg.head_dim), dtype=dtype,
                                   device=device) for _ in range(2)) for key, n in kv.items()}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device="cuda"):
    """Zero cache ``{"groups": {"sub_<i>": ...}, "tail_<i>": ...}`` of the
    per-char caches of ``_sublayer_cache``, the group stack leading."""
    _require_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or L.torch_dtype(cfg.dtype)
    ng, cross = n_full_groups(cfg), cfg.family == "encdec"
    cache = {"groups": {f"sub_{i}": tree_map(lambda a: a.new_zeros((ng,) + a.shape),
                                             _sublayer_cache(cfg, ch, batch, max_seq, dtype,
                                                             device, cross))
                        for i, ch in enumerate(group_chars(cfg))}}
    for i, ch in enumerate(tail_chars(cfg)):
        cache[f"tail_{i}"] = _sublayer_cache(cfg, ch, batch, max_seq, dtype, device, cross)
    return cache


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def decode_step(params, tokens, cache, cache_pos: int, cfg: ModelConfig, *, lora=None,
                enc_out=None):
    """One-token decode at position ``cache_pos``. tokens: (B, 1). An
    ``encdec`` step adds ``dec_pos[cache_pos]`` and cross-attends to the
    ``cross`` cache that the prefill filled (or, if given, to ``enc_out``).
    Returns (logits (B,1,V), cache)."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    if cfg.family == "encdec":
        x = x + params["dec_pos"][None, cache_pos:cache_pos + 1].to(x.dtype)
    positions = torch.full((tokens.shape[0], 1), cache_pos, dtype=torch.int64,
                           device=tokens.device)
    x, _ = _scan_groups(params, x, cfg, cache=cache, cache_pos=cache_pos, positions=positions,
                        lora=lora, enc_out=enc_out)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x, cfg), cache


def prefill(params, batch, cfg: ModelConfig, cache, *, lora=None, kernels=True):
    """Prefill: run the full prompt (vlm: the Tv patches and the S tokens;
    encdec: the encoder first, its keys and values written into every
    layer's ``cross`` cache), writing the cache. Returns (logits, cache)."""
    enc_out = _encode(params, batch, cfg, lora=lora, kernels=kernels)
    x, positions = _embed_inputs(params, batch, cfg)
    x, _ = _scan_groups(params, x, cfg, cache=cache, cache_pos=0, positions=positions,
                        lora=lora, kernels=kernels, q_chunk=_q_chunk(x.shape[1]),
                        enc_out=enc_out)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x, cfg), cache
