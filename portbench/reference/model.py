"""A dense decoder with LoRA in float32: RMSNorm, split-half RoPE over the
whole head, causal GQA attention, SwiGLU, tied or untied head, and every
targeted projection x·W + (α/r)·(x·A)·B.

Weights are the benchmark's flat layout (``harness/weights.py``), upcast to
float32 a layer at a time. ``quant`` (the precision control) rounds both
operands of every projection and of the head before the product, and passes
gradients straight through; None computes in float32 throughout.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

Q_CHUNK = 512  # queries per attention block: the scores held at once are (rows, H, 512, S)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _q(t, quant):
    if quant is None:
        return t
    return t + (quant(t.detach()) - t.detach())  # straight-through


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x (n, S, heads, hd), positions 0..S-1; the two halves of each head rotate together."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v):
    """Causal GQA softmax attention in blocks of queries. q (n, S, H, hd),
    k/v (n, S, Kv, hd) -> (n, S, H·hd)."""
    n, S, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)  # (n, H, S, hd)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = []
    for i in range(0, S, Q_CHUNK):
        qi = q[:, :, i:i + Q_CHUNK]
        s = qi @ k.transpose(-1, -2) / math.sqrt(hd)
        qpos = torch.arange(i, i + qi.shape[2], device=q.device)[:, None]
        s = s.masked_fill(torch.arange(S, device=q.device)[None, :] > qpos, float("-inf"))
        out.append(torch.softmax(s, dim=-1) @ v)
    return torch.cat(out, dim=2).transpose(1, 2).reshape(n, S, H * hd)


class Model:
    """The reference decoder over the benchmark's weights ``w`` and adapters
    ``ad`` (float32 leaves, or the benchmark's own, upcast as used)."""

    def __init__(self, cfg: dict, w: dict, ad: dict, quant=None):
        self.cfg, self.w, self.ad, self.quant = cfg, w, ad, quant
        self.scale = cfg["lora"]["alpha"] / cfg["lora"]["rank"]
        self.eps = cfg["rms_norm_eps"]

    def proj(self, x, name: str, layer: int):
        w = self.w[name][layer].float()
        y = _q(x, self.quant) @ _q(w, self.quant)
        if name in self.ad:
            a = self.ad[name]["A"][layer].float()
            b = self.ad[name]["B"][layer].float()
            u = _q(x, self.quant) @ _q(a, self.quant)
            y = y + self.scale * (_q(u, self.quant) @ _q(b, self.quant))
        return y

    def layer(self, x, i: int):
        c = self.cfg
        n, S, _ = x.shape
        H, Kv, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
        h = rms_norm(x, self.w["norm1"][i].float(), self.eps)
        q = rope(self.proj(h, "wq", i).reshape(n, S, H, hd), c["rope_theta"])
        k = rope(self.proj(h, "wk", i).reshape(n, S, Kv, hd), c["rope_theta"])
        v = self.proj(h, "wv", i).reshape(n, S, Kv, hd)
        x = x + self.proj(attention(q, k, v), "wo", i)
        h = rms_norm(x, self.w["norm2"][i].float(), self.eps)
        return x + self.proj(F.silu(self.proj(h, "w_gate", i)) * self.proj(h, "w_up", i),
                             "w_down", i)

    def hidden(self, tokens):
        """Final-normed hidden states (n, S, D) of the token ids (n, S)."""
        x = F.embedding(tokens, self.w["embed"]).float()
        for i in range(self.cfg["num_layers"]):
            x = self.layer(x, i)
        return rms_norm(x, self.w["final_norm"].float(), self.eps)

    def head_t(self, lo: int = 0, hi=None):
        """The head's columns lo:hi as a float32 (D, cols) matrix."""
        if "head" in self.w:
            return self.w["head"][:, lo:hi].float()
        return self.w["embed"][lo:hi].float().T

    def logits(self, x, vocab_block: int = 1 << 15):
        """fp32 logits of hidden states x (..., D), a block of the vocabulary at a time."""
        V = self.cfg["vocab_size"]
        return torch.cat([_q(x, self.quant) @ _q(self.head_t(lo, lo + vocab_block), self.quant)
                          for lo in range(0, V, vocab_block)], dim=-1)

    def loss(self, tokens, labels):
        """Mean token cross-entropy of (n, S) tokens against (n, S) labels."""
        logits = self.logits(self.hidden(tokens))
        V = logits.shape[-1]
        return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))


@torch.no_grad()
def last_logits(cfg: dict, w: dict, ad: dict, tokens, rows: int = 4, quant=None):
    """fp32 logits (n, V) at the last position of each prompt of ``tokens``
    (n, S), ``rows`` prompts at a time."""
    with no_tf32():
        model = Model(cfg, w, ad, quant)
        return torch.cat([model.logits(model.hidden(tokens[i:i + rows])[:, -1])
                          for i in range(0, tokens.shape[0], rows)])
