"""One FedsLLM global round (paper Algorithms 1 + 2) by plain autograd in
float32, over the whole model at once: the split between client and server
changes no value of the round, so the reference does not make it.

For each client k, with Δw the global adapters:
  g_k0 = ∇F_k(Δw);  ḡ = Σ_k w̄_k g_k0 (w̄: the aggregation weights, normalised);
  h = 0; I_loc times: h ← h − δ·(∇F_k(Δw + h) − g_k0 + ξ·ḡ);
and then Δw ← Δw + α·Σ_k w̄_k h_k. F_k is the mean token cross-entropy of
client k's batch.
"""

from __future__ import annotations

import torch

from portbench.reference.model import Model, no_tf32


def _add(a, b, s=1.0):
    return {n: {k: a[n][k] + s * b[n][k] for k in a[n]} for n in a}


def _grads(cfg, w, ad, tokens, labels, quant):
    leaves = {n: {k: t.detach().requires_grad_() for k, t in ab.items()} for n, ab in ad.items()}
    with torch.enable_grad():
        loss = Model(cfg, w, leaves, quant).loss(tokens, labels)
        flat = [t for ab in leaves.values() for t in ab.values()]
        got = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), {n: {k: next(got) for k in ab} for n, ab in leaves.items()}


def fedsllm_round(cfg: dict, w: dict, ad: dict, batches, weights, *, I_loc: int, xi: float,
                  delta: float, alpha: float = 1.0, quant=None):
    """One round from the float32 adapters ``ad`` over ``batches`` (a list of
    K (tokens, labels) pairs, each (B, S)) with aggregation weights
    ``weights`` (K,). Returns (new adapters, {"loss_round_start",
    "loss_local_final"}: the mean over clients of the first and of the last
    local step's loss)."""
    wn = [float(x) / float(sum(weights)) for x in weights]
    with no_tf32():
        start = [_grads(cfg, w, ad, t, l, quant) for t, l in batches]
        gbar = {n: {k: sum(wk * g[n][k] for wk, (_, g) in zip(wn, start)) for k in ad[n]}
                for n in ad}
        upd = {n: {k: torch.zeros_like(t) for k, t in ab.items()} for n, ab in ad.items()}
        last = []
        for (t, l), (_, g0), wk in zip(batches, start, wn):
            h = {n: {k: torch.zeros_like(v) for k, v in ab.items()} for n, ab in ad.items()}
            for _ in range(I_loc):
                loss, g = _grads(cfg, w, _add(ad, h), t, l, quant)
                h = {n: {k: h[n][k] - delta * (g[n][k] - g0[n][k] + xi * gbar[n][k])
                         for k in h[n]} for n in h}
            last.append(loss)
            upd = _add(upd, h, wk)
    new = _add(ad, upd, alpha)
    losses = {"loss_round_start": torch.stack([s[0] for s in start]).mean(),
              "loss_local_final": torch.stack(last).mean()}
    return new, losses
