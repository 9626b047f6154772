"""The yardstick's arithmetic: one H100's published peaks, the operations and
bytes of the port's kernels, and the model FLOPs behind ``mfu.*``.

Frozen here so that no later change to the program can move it. The kernel
counts are those of ``chip_smoke.py`` (``lora_work``, ``attn_work``,
``bound_ms``) at the time the benchmark was defined.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W: the bf16
# tensor-core peak and HBM3's bandwidth
PEAK_BF16 = 989e12  # FLOP/s
HBM_BYTES_PER_S = 3.35e12


def least_s(nbytes: float, ops: float, peak: float = PEAK_BF16) -> float:
    """The least time the card could take: its bytes at HBM's rate or its
    operations at the peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def lora_work(M: int, K: int, N: int, r: int, esize: int = 2) -> tuple[int, int]:
    """Bytes and operations of y = x·W + s·(x·A)·B, x (M, K), W (K, N), A (K, r),
    B (r, N): every input read once and y written once."""
    nbytes = esize * (M * K + K * N + K * r + r * N + M * N)
    ops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N
    return nbytes, ops


def causal_pairs(S: int) -> int:
    """Score entries a causal attention over S positions needs."""
    return S * (S + 1) // 2


def attn_work(B: int, S: int, H: int, Kv: int, d: int, esize: int = 2) -> tuple[int, int]:
    """Bytes and operations of causal GQA flash attention: q, k, v read once,
    o written once; Q·Kᵀ and P·V over the causal pairs."""
    nbytes = esize * (2 * B * H * S * d + 2 * B * Kv * S * d)
    ops = 4 * B * H * causal_pairs(S) * d
    return nbytes, ops


def projections(cfg: dict) -> list[tuple[str, int, int]]:
    """(name, K, N) of one dense layer's adapted projections."""
    D, H, Kv, hd, F = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"],
                       cfg["d_ff"])
    return [("wq", D, H * hd), ("wk", D, Kv * hd), ("wv", D, Kv * hd), ("wo", H * hd, D),
            ("w_gate", D, F), ("w_up", D, F), ("w_down", F, D)]


def forward_flops(cfg: dict, B: int, S: int, head_positions: int) -> int:
    """Model FLOPs of one forward pass over B sequences of S tokens: every
    layer's projections and their LoRA products, causal attention, and the
    head at ``head_positions`` positions of each sequence."""
    T, r, L = B * S, cfg["lora"]["rank"], cfg["num_layers"]
    proj = sum(2 * T * K * N + 2 * T * r * (K + N) for _, K, N in projections(cfg))
    attn = 4 * B * cfg["num_heads"] * causal_pairs(S) * cfg["head_dim"]
    head = 2 * B * head_positions * cfg["d_model"] * cfg["vocab_size"]
    return L * (proj + attn) + head


def train_pass_flops(cfg: dict, B: int, S: int) -> int:
    """Model FLOPs of one split pass of LoRA fine-tuning (forward, loss and
    backward) over B sequences of S tokens, with the base frozen: the forward
    (head at every position), the activations' gradients (one product per
    forward product; none into the first layer's q/k/v inputs, which hold no
    parameter below them), causal attention's backward (twice its forward),
    and the adapters' gradients (dA, dB and the gradient through u = x·A).
    No recomputation and no merge of the adapters into the weights."""
    T, r, L = B * S, cfg["lora"]["rank"], cfg["num_layers"]
    fwd = forward_flops(cfg, B, S, S)
    dx = sum(2 * T * K * N for _, K, N in projections(cfg))
    first_qkv = sum(2 * T * K * N + 2 * T * r * K for name, K, N in projections(cfg)
                    if name in ("wq", "wk", "wv"))
    lora_bwd = sum(4 * T * r * (K + N) for _, K, N in projections(cfg))
    attn_bwd = 8 * B * cfg["num_heads"] * causal_pairs(S) * cfg["head_dim"]
    head_bwd = 2 * T * cfg["d_model"] * cfg["vocab_size"]
    return fwd + L * (dx + lora_bwd + attn_bwd) - first_qkv + head_bwd
