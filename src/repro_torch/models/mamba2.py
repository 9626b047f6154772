"""Mamba-2 (state-space duality, SSD) block (port of ``repro/models/mamba2.py``).

Prefill runs the SSD through the CUDA chunked-scan kernel (``kernels=True``:
``kernels/ssd_ops.ssd_scan``) or through ``ssd_chunked``, the plain chunked
form of the reference; decode is the one-token state update
``ssd_decode_step``. ``in_proj`` and ``out_proj`` go through
``layers.project``, so an adapted one runs the fused LoRA kernel.

State cache layout, per layer: (conv_state (B, W-1, conv_ch) in the working
dtype, ssd_state (B, H, P, N) in fp32), both updated in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_ops import ssd_scan
from repro_torch.models import layers as L


def dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim  # ssm heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_ch = d_inner + 2 * N  # x, B, C pass through the conv
    return d_inner, H, P, N, conv_ch


def init_mamba(gen, cfg: ModelConfig, device=None):
    """The reference's shapes and inits: A_log = dt_bias = conv_b = 0 and
    D_skip = 1 (so A = -1 on every head)."""
    D = cfg.d_model
    d_inner, H, P, N, conv_ch = dims(cfg)
    in_dim = 2 * d_inner + 2 * N + H  # z, x, B, C, dt
    pd = cfg.param_dtype
    mk = lambda shape, dtype, **kw: L.make_param(gen, shape, dtype, device=device, **kw)
    return {
        "in_proj": mk((D, in_dim), pd),
        "conv_w": mk((cfg.ssm_conv_width, conv_ch), pd, scale=1.0 / math.sqrt(cfg.ssm_conv_width)),
        "conv_b": mk((conv_ch,), pd, init="zeros"),
        "A_log": mk((H,), "float32", init="zeros"),
        "D_skip": mk((H,), "float32", init="ones"),
        "dt_bias": mk((H,), "float32", init="zeros"),
        "norm_scale": mk((d_inner,), pd, init="ones"),
        "out_proj": mk((d_inner, D), pd, scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }


def _causal_conv(xBC, w, b, state=None):
    """Depthwise causal conv of width W. xBC (B,S,ch); w (W,ch); state
    (B,W-1,ch) or None. Returns (silu(conv + b) in xBC.dtype, new state: the
    last W-1 rows of [state ‖ xBC])."""
    W = w.shape[0]
    B, S, ch = xBC.shape
    pad = (torch.zeros((B, W - 1, ch), dtype=xBC.dtype, device=xBC.device) if state is None
           else state.to(xBC.dtype))
    full = torch.cat([pad, xBC], dim=1)  # (B, S+W-1, ch)
    out = torch.zeros((B, S, ch), dtype=torch.float32, device=xBC.device)
    for i in range(W):  # W = 4: the reference's unrolled sum, in its order
        out = out + full[:, i:i + S].float() * w[i].float()
    out = F.silu(out + b.float()).to(xBC.dtype)
    return out, full[:, S:]


def _segsum(log_a):
    """log_a (..., Q) -> (..., Q, Q): L[q, s] = sum_{t=s+1..q} log_a_t for
    s <= q, -inf above the diagonal."""
    c = torch.cumsum(log_a, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    Q = log_a.shape[-1]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=log_a.device))
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD, the plain path. x (B,S,H,P); dt (B,S,H); A (H,)
    (negative); Bm/Cm (B,S,N). Returns (y (B,S,H,P), final_state (B,H,P,N)),
    both fp32."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        # pad to a chunk multiple: dt = 0 -> decay 1, input 0 (state-neutral)
        pad = Q - S % Q
        y, h = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
                           F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad)), Q,
                           initial_state)
        return y[:, :S], h
    nc = S // Q

    dtf = dt.float()
    log_a = dtf * A.float()  # (B,S,H), negative
    xw = x.float() * dtf[..., None]  # dt-weighted inputs

    la = log_a.reshape(B, nc, Q, H)
    xc = xw.reshape(B, nc, Q, H, P)
    Bc = Bm.float().reshape(B, nc, Q, N)
    Cc = Cm.float().reshape(B, nc, Q, N)

    # intra-chunk (quadratic)
    Lmat = torch.exp(_segsum(la.transpose(-1, -2)))  # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)[:, :, None] * Lmat
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", scores, xc)

    # chunk states
    la_sum = la.sum(dim=2)  # (B,nc,H)
    cum = torch.cumsum(la, dim=2)
    decay_to_end = torch.exp(la_sum[:, :, None, :] - cum)  # (B,nc,Q,H)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc, decay_to_end, xc)

    # inter-chunk recurrence (sequential over chunks)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(la_sum[:, c])[:, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (B,nc,H,P,N): state entering each chunk

    # inter-chunk contribution
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, torch.exp(cum), h_prevs)
    return (y_intra + y_inter).reshape(B, S, H, P), h


def ssd_decode_step(x, dt, A, Bm, Cm, state):
    """One-token SSD update. x (B,1,H,P); dt (B,1,H); Bm/Cm (B,1,N); state
    (B,H,P,N) fp32. Returns (y (B,1,H,P) fp32, new state)."""
    dtf = dt.float()[:, 0]  # (B,H)
    a = torch.exp(dtf * A.float())
    xw = x.float()[:, 0] * dtf[..., None]  # (B,H,P)
    new_state = state * a[:, :, None, None] + torch.einsum("bhp,bn->bhpn", xw, Bm.float()[:, 0])
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float()[:, 0])
    return y[:, None], new_state


def apply_mamba(p, u, cfg: ModelConfig, cache=None, *, adapters=None, kernels: bool = True):
    """u (B,S,D). cache: (conv_state, ssd_state), written in place, or None.
    A cache and S == 1 decode one step; anything else is a prefill, from the
    cache's state if there is one. Returns (B,S,D)."""
    B, S, D = u.shape
    d_inner, H, P, N, conv_ch = dims(cfg)
    ad = adapters or {}
    zxbcdt = L.project(u, p["in_proj"], ad.get("in_proj"))
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_ch]
    dt_raw = zxbcdt[..., d_inner + conv_ch:]  # (B,S,H)

    xBC, new_conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                       cache[0] if cache is not None else None)
    x = xBC[..., :d_inner].unflatten(-1, (H, P))
    Bm = xBC[..., d_inner:d_inner + N]
    Cm = xBC[..., d_inner + N:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if cache is not None and S == 1:
        y, new_state = ssd_decode_step(x, dt, A, Bm, Cm, cache[1])
    else:
        h0 = cache[1] if cache is not None else None
        if kernels:
            y, new_state = ssd_scan(x, dt, A, Bm, Cm, initial_state=h0)
        else:
            y, new_state = ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk, h0)
    if cache is not None:
        cache[0].copy_(new_conv_state)
        cache[1].copy_(new_state)

    y = y + x.float() * p["D_skip"].float()[None, None, :, None]
    y = y.reshape(B, S, d_inner).to(u.dtype)

    # gated RMSNorm (mamba2: norm(y * silu(z)))
    gf = (y * F.silu(z)).float()
    var = torch.mean(gf * gf, dim=-1, keepdim=True)
    g = (gf * torch.rsqrt(var + 1e-6) * p["norm_scale"].float()).to(u.dtype)
    return L.project(g, p["out_proj"], ad.get("out_proj"))


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device="cuda"):
    device = resolve_device(device)
    d_inner, H, P, N, conv_ch = dims(cfg)
    conv_state = torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch), dtype=dtype, device=device)
    ssd_state = torch.zeros((batch, H, P, N), dtype=torch.float32, device=device)
    return conv_state, ssd_state
