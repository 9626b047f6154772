"""Weights, adapters and tokens drawn from ``--seed`` on the device.

The benchmark makes them itself and hands the same tensors to the program
and to the plain reference. Its own layout is flat: ``embed`` (V, D),
``head`` (D, V) unless tied, ``final_norm`` (D,), and per layer, stacked
(L, ...): ``norm1``, ``norm2`` and the seven projections in (d_in, d_out)
layout. Adapters: ``{projection: {"A": (L, d_in, r), "B": (L, r, d_out)}}``
with B != 0, as in the middle of a fine-tuning campaign. Every leaf is one
``torch.randn`` in the served type from one generator on the device.
"""

from __future__ import annotations

import math

import torch

STD = 0.02  # weights ~ N(0, STD²); output projections STD / sqrt(2L)
NORM_JITTER = 0.1  # norm scales 1 + NORM_JITTER · N(0, 1)
ATTN = ("wq", "wk", "wv", "wo")
MLP = ("w_gate", "w_up", "w_down")
OUT_PROJ = ("wo", "w_down")

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of the seed's draws (the seed
    may exceed 32 bits; streams keep weights, adapters and tokens apart)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % 2**63)


def shapes(cfg: dict) -> dict:
    D, H, Kv, hd, F, V, L = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                             cfg["head_dim"], cfg["d_ff"], cfg["vocab_size"], cfg["num_layers"])
    out = {"embed": (V, D), "final_norm": (D,), "norm1": (L, D), "norm2": (L, D),
           "wq": (L, D, H * hd), "wk": (L, D, Kv * hd), "wv": (L, D, Kv * hd), "wo": (L, H * hd, D),
           "w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D)}
    if not cfg["tie_embeddings"]:
        out["head"] = (D, V)
    return out


def std_of(cfg: dict, name: str) -> float:
    return STD / math.sqrt(2 * cfg["num_layers"]) if name in OUT_PROJ else STD


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> dict:
    gen = generator(seed, 0, device)
    dtype = DTYPES[cfg["dtype"]]
    out = {}
    for name, shape in shapes(cfg).items():
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        if name in ("final_norm", "norm1", "norm2"):
            out[name] = w.mul_(NORM_JITTER).add_(1.0)
        else:
            out[name] = w.mul_(std_of(cfg, name))
    return out


@torch.no_grad()
def make_adapters(cfg: dict, seed: int, device, b_to_w_std: float) -> dict:
    """A ~ N(0, 1/r²) (the program's own initial scale); B ~ N(0, (b_to_w_std ·
    the weight's std)²), so that every adapter changes its projection's
    output by about b_to_w_std / 2 of the weight's own share."""
    gen = generator(seed, 1, device)
    dtype = DTYPES[cfg["dtype"]]
    sh, r = shapes(cfg), cfg["lora"]["rank"]
    out = {}
    for name in cfg["lora"]["targets"]:
        L, K, N = sh[name]
        a = torch.randn((L, K, r), generator=gen, dtype=dtype, device=device).mul_(1.0 / r)
        b = torch.randn((L, r, N), generator=gen, dtype=dtype, device=device)
        out[name] = {"A": a, "B": b.mul_(b_to_w_std * std_of(cfg, name))}
    return out


def tokens(seed: int, stream: int, shape: tuple, vocab: int, device) -> torch.Tensor:
    """Token ids uniform over the vocabulary, from the seed's ``stream``."""
    gen = generator(seed, 2 + stream, device)
    return torch.randint(0, vocab, shape, generator=gen, device=device)


# ---------------------------------------------------------------------------
# The program's layouts (``repro_torch.models.transformer.init_params`` and
# ``repro_torch.core.lora``): views of the same tensors, nothing copied
# ---------------------------------------------------------------------------


def keystr(path) -> str:
    return "".join(f"['{k}']" for k in path)


def path_of(name: str) -> tuple:
    return ("groups", "sub_0", "attn" if name in ATTN else "mlp", name)


def program_params(w: dict) -> dict:
    embed = {"tokens": w["embed"]}
    if "head" in w:
        embed["head"] = w["head"]
    sub = {"norm1": {"scale": w["norm1"]}, "attn": {k: w[k] for k in ATTN},
           "norm2": {"scale": w["norm2"]}, "mlp": {k: w[k] for k in MLP}}
    return {"embed": embed, "groups": {"sub_0": sub}, "final_norm": {"scale": w["final_norm"]}}


def program_lora(adapters: dict) -> dict:
    return {keystr(path_of(name)): dict(ab) for name, ab in adapters.items()}


def program_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.config import LoRAConfig, ModelConfig

    # what the port's dense decoder computes, and nothing else
    fixed = {"mlp": "swiglu", "norm": "rmsnorm", "rms_norm_eps": 1e-6,
             "partial_rotary_factor": 1.0, "rope_scaling": None}
    wrong = {k: cfg.get(k) for k, v in fixed.items() if cfg.get(k) != v}
    if wrong:
        raise ValueError(f"{cfg['name']}: the port runs {fixed}, not {wrong}")
    lora = cfg["lora"]
    return ModelConfig(
        name=cfg["name"], family="dense", num_layers=cfg["num_layers"], d_model=cfg["d_model"],
        num_heads=cfg["num_heads"], num_kv_heads=cfg["num_kv_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["d_ff"], vocab_size=cfg["vocab_size"], rope_theta=cfg["rope_theta"],
        use_rope=True, layer_pattern="G", mlp_activation="swiglu", norm_type="rmsnorm",
        tie_embeddings=cfg["tie_embeddings"], dtype=cfg["dtype"], param_dtype=cfg["dtype"],
        lora=LoRAConfig(rank=lora["rank"], alpha=lora["alpha"], targets=tuple(lora["targets"])))
