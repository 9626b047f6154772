"""Model registry (port of ``repro/models/registry.py``): the bound model API
the parameter count that sizes the delay model's |w|, and the MoE configs'
active count."""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves


class Model(NamedTuple):
    """Bound model API (parameters passed explicitly)."""

    cfg: ModelConfig
    init: Callable  # (seed=0, device="cuda") -> params
    loss: Callable  # (params, batch) -> (loss, metrics)
    forward: Callable  # (params, batch, lora=None, kernels=True) -> logits
    prefill: Callable  # (params, batch, cache, lora=None) -> (logits, cache)
    decode_step: Callable  # (params, tokens, cache, pos, lora=None) -> (logits, cache)
    init_cache: Callable  # (batch, max_seq, dtype=None, device="cuda") -> cache


def build_model(cfg: ModelConfig, remat: bool = False) -> Model:
    def init(seed=0, device="cuda"):
        return T.init_params(cfg, seed=seed, device=device)

    def loss(params, batch):
        return T.loss_fn(params, batch, cfg, remat=remat)

    def forward(params, batch, lora=None, kernels=True):
        return T.forward(params, batch, cfg, lora=lora, kernels=kernels)

    def prefill(params, batch, cache, lora=None):
        return T.prefill(params, batch, cfg, cache, lora=lora)

    def decode_step(params, tokens, cache, pos, lora=None):
        return T.decode_step(params, tokens, cache, pos, cfg, lora=lora)

    def init_cache(batch, max_seq, dtype=None, device="cuda"):
        return T.init_cache(cfg, batch, max_seq, dtype=dtype, device=device)

    return Model(cfg, init, loss, forward, prefill, decode_step, init_cache)


def count_params(cfg: ModelConfig, trainable_only: bool = False) -> int:
    """Total parameter count, the element count of ``init_params`` on the
    meta device (shapes only, nothing drawn); with ``trainable_only``, the
    LoRA adapters'."""
    if trainable_only:
        from repro_torch.core.lora import lora_param_count

        return lora_param_count(cfg)
    return sum(t.numel() for t in tree_leaves(T.init_params(cfg, device="meta")))


def active_param_count(cfg: ModelConfig) -> int:
    """MoE: the parameters one token touches (MODEL_FLOPS = 6·N_active·D),
    the count of the config with its experts cut to the top k, as the
    reference counts it (router included, at k columns); every other
    family: ``count_params``."""
    if not cfg.num_experts:
        return count_params(cfg)
    return count_params(cfg.replace(num_experts=cfg.num_experts_per_tok))
