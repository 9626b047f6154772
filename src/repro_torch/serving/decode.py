"""Batched serving: prefill + single-token decode loop with a KV cache
(attention) or a state cache (SSM) (port of ``repro/serving/decode.py``).

Greedy decoding is the contract; ``sample="categorical"`` draws from an
explicit ``torch.Generator``. ``lora`` (adapters keyed as in
``core/lora.py``) is optional: without it every projection is a plain
``x @ W``; with it, every adapted projection runs the fused LoRA kernel.

The encoder-decoder and vision-language families take their stub inputs
(``frame_embeds``, ``vision_embeds``) in the prefill's batch. An encoder's
keys and values reach the decode steps through each layer's ``cross``
cache, and a vision prefill writes Tv + S positions, from which decoding
goes on. (The reference's decode loop carries no encoder output, so its
decode steps of whisper skip the cross-attention and fail, and it starts
decoding a vision prompt at position S, overwriting the cache there.)
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


class DecodeState(NamedTuple):
    cache: Any
    pos: int  # current absolute position
    tokens: torch.Tensor  # last emitted token (B, 1)
    enc_out: Optional[torch.Tensor] = None  # encdec; None: decode reads the cross cache


def make_prefill_fn(cfg: ModelConfig):
    def prefill_fn(params, batch, cache, lora=None):
        logits, cache = T.prefill(params, batch, cfg, cache, lora=lora)
        last = torch.argmax(logits[:, -1:, :], dim=-1)
        return DecodeState(cache, logits.shape[1], last)  # the positions written

    return prefill_fn


def make_decode_fn(cfg: ModelConfig, sample: str = "greedy", temperature: float = 1.0):
    if sample not in ("greedy", "categorical"):
        raise ValueError(f"sample={sample!r}: greedy or categorical")

    def decode_fn(params, state: DecodeState, generator: Optional[torch.Generator] = None,
                  lora=None):
        logits, cache = T.decode_step(params, state.tokens, state.cache, state.pos, cfg,
                                      lora=lora, enc_out=state.enc_out)
        if sample == "greedy":
            nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        else:
            probs = torch.softmax(logits[:, -1, :] / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)
        return DecodeState(cache, state.pos + 1, nxt, state.enc_out), logits

    return decode_fn


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@torch.no_grad()
def decode_tokens(params, cfg: ModelConfig, prompt, max_new: int,
                  max_seq: Optional[int] = None, sample: str = "greedy", seed: int = 0, *,
                  lora=None, device="cuda", inputs=None):
    """Prefill ``prompt`` (B, S) then generate: the prefill's argmax and
    ``max_new - 1`` decoded tokens, (B, max_new). Runs on ``device``.
    ``inputs``: the stub inputs merged into the prefill's batch
    (``{"frame_embeds": (B, encoder_seq, D)}`` for encdec,
    ``{"vision_embeds": (B, Tv, 1024)}`` for vlm). The cache holds
    ``max_seq`` (default Tv + S + max_new) positions, a sliding-window
    layer's min(window, max_seq) slots (``transformer.init_cache``)."""
    dev = resolve_device(device)
    params = _to(params, dev)
    lora = _to(lora, dev) if lora is not None else None
    prompt = prompt.to(dev)
    batch = {"tokens": prompt, "labels": prompt, **_to(dict(inputs or {}), dev)}
    B, S = prompt.shape
    Tv = batch["vision_embeds"].shape[1] if cfg.family == "vlm" and "vision_embeds" in batch \
        else 0
    cache = T.init_cache(cfg, B, max_seq or (Tv + S + max_new), device=dev)
    decode_fn = make_decode_fn(cfg, sample=sample)
    state = make_prefill_fn(cfg)(params, batch, cache, lora)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = [state.tokens]
    for _ in range(max_new - 1):
        state, _ = decode_fn(params, state, gen, lora)
        out.append(state.tokens)
    return torch.cat(out, dim=1)
