"""Model, LoRA, FedsLLM and run configuration for the PyTorch port.

The port's own copy of the configuration dataclasses of ``repro.config``: the
fields are the same, so a registered architecture reads identically in both
packages (``models/transformer.py``'s ``PORTED`` names the family and layer
pattern pairs that run). ``ModelConfig`` keeps every field of the reference so that configuration
modules copy over verbatim; ``FedsLLMConfig`` (the paper's §III/IV
settings) is copied field for field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass(frozen=True)
class LoRAConfig:
    """Low-rank adaptation (paper eq. (1): w0 + B·A, r << min(d, k))."""

    rank: int = 16
    alpha: float = 32.0
    # Which projection weights receive adapters, matched by leaf name.
    targets: tuple[str, ...] = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                                "in_proj", "out_proj", "w_rec_in", "w_gate_in", "w_out")
    dropout: float = 0.0

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


@dataclass(frozen=True)
class ModelConfig:
    """One config object for every family of the reference zoo."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention options -------------------------------------------------
    rope_theta: float = 10_000.0
    use_rope: bool = True
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    sliding_window: int = 0
    layer_pattern: str = "G"

    # --- block options -----------------------------------------------------
    mlp_activation: str = "swiglu"
    norm_type: str = "rmsnorm"
    use_bias: bool = False
    use_post_norm: bool = False
    parallel_block: bool = False
    tie_embeddings: bool = False
    embedding_multiplier: float = 1.0
    logit_scale: float = 1.0

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_router_norm: bool = True

    # --- SSM (mamba2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- hybrid (RG-LRU) ----------------------------------------------------
    lru_width: int = 0

    # --- enc-dec ------------------------------------------------------------
    num_encoder_layers: int = 0
    encoder_seq: int = 1500

    # --- VLM ----------------------------------------------------------------
    vision_tokens: int = 0

    # --- numerics -----------------------------------------------------------
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "bfloat16"
    lora: Optional[LoRAConfig] = None

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "hybrid" and self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def pattern(self) -> str:
        """Layer-type pattern tiled to full depth."""
        p = self.layer_pattern
        return (p * -(-self.num_layers // len(p)))[: self.num_layers]

    def param_count(self, trainable_only: bool = False) -> int:
        """Parameter count (``models.registry.count_params``)."""
        from repro_torch.models.registry import count_params

        return count_params(self, trainable_only=trainable_only)

    @property
    def group_size(self) -> int:
        """Layers per scan group (one copy of the pattern)."""
        return len(self.layer_pattern)

    @property
    def num_groups(self) -> int:
        """Full scanned groups; remainder layers are an unscanned tail."""
        return self.num_layers // self.group_size

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FedsLLMConfig:
    """Paper Section III/IV settings (defaults = the paper's simulation)."""

    num_clients: int = 50
    area_m: float = 500.0  # 500 m x 500 m square, BS at centre
    split_ratio_min: float = 0.1  # A_min
    split_ratio_max: float = 0.9  # A_max
    # Lemma constants
    xi: float = 0.1  # ξ
    delta: float = 0.1  # δ (local GD step size)
    epsilon0: float = 1e-3  # ε0 target global accuracy
    L_smooth: float = 1.0  # L (Lipschitz)
    gamma_strong: float = 1.0  # γ (strong convexity)
    # channel / radio
    bandwidth_total_hz: float = 20e6  # B_c = B_s = 20 MHz
    noise_psd_dbm_hz: float = -174.0  # N0
    pathloss_const_db: float = 128.1
    pathloss_exp: float = 37.6  # 128.1 + 37.6 log10(d_km)
    shadow_std_db: float = 8.0
    p_max_dbm: float = 10.0  # per-user max tx power
    # compute
    f_max_hz: float = 2e9  # client CPU 2 GHz
    f_server_hz: float = 1e10  # main server (>> clients)
    cycles_per_param_low: float = 1e4  # C_k ~ U[1,3]x1e4
    cycles_per_param_high: float = 3e4
    kappa: float = 1e-28  # effective switched capacitance
    # data volumes
    s_c_bits: float = 28.1e3  # client->fed server per round
    s_bits: float = 281e3  # client->main server per local iteration
    # dataset
    num_samples: int = 60_021  # BlogFeedback [12]
    sample_dim: int = 281
    # eta sweep
    eta_step: float = 0.01
    # training-η policy (repro.api.Experiment): η* from the allocator is
    # clamped to ≤ eta_train_max so Lemma 2 keeps a non-trivial local
    # iteration count; joint per-round re-solves (reallocate=True) quantize
    # the adopted η to the eta_bucket grid so the campaign reuses one jitted
    # round function per bucket instead of recompiling every round
    eta_train_max: float = 0.5
    eta_bucket: float = 0.05


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# Archs allowed to run long_500k (sub-quadratic sequence mixing only).
LONG_CONTEXT_OK = ("mamba2-130m", "recurrentgemma-9b")


def shape_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_OK
    return True


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1_000
    grad_clip: float = 1.0
    optimizer: str = "adamw"  # adamw | sgd | adafactor
    remat: str = "full"  # none | full | dots
    seed: int = 0
    microbatch: int = 0  # 0 = no accumulation
    moment_dtype: str = "float32"


@dataclass(frozen=True)
class RunConfig:
    """What ``api.Experiment.from_config`` reads: the model, the §IV system
    (paper defaults when None) and ``train.seed``. The reference's ``mesh``
    field (a TPU mesh) has no counterpart on one card."""

    model: ModelConfig
    shape: ShapeConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    fedsllm: Optional[FedsLLMConfig] = None


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_arch(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (configs register on import)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401  (configs register on import)

    return sorted(_REGISTRY)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    kw: dict[str, Any] = dict(
        name=cfg.name + "-smoke",
        num_layers=max(2, len(cfg.layer_pattern)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        dtype="float32",
        param_dtype="float32",
    )
    if cfg.num_experts:
        kw.update(num_experts=8, num_experts_per_tok=2)
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        kw.update(lru_width=64, sliding_window=32)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    if cfg.family == "encdec":
        kw.update(num_encoder_layers=2, encoder_seq=32)
    if cfg.family == "vlm":
        kw.update(vision_tokens=8)
    return cfg.replace(**kw)
