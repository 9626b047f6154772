"""Plain PyTorch version of the SSD scan (after ``repro/kernels/ssd_ref.py``):
the exact sequential recurrence

    h_t = exp(dt_t·A)·h_{t-1} + dt_t·(x_t ⊗ B_t),    y_t = h_t·C_t

extended with an initial state and the final state, as the model's prefill
needs them; and ``ssd_scan_split_ref``, the chunked arithmetic of the CUDA
kernel's ``wgmma`` variant (two-term bf16 splits), for the tests."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def ssd_scan_ref(x, dt, A, Bm, Cm, initial_state=None):
    """x (B,S,H,P); dt (B,S,H); A (H,); Bm/Cm (B,S,N); initial_state
    (B,H,P,N) or None (zeros). Returns (y (B,S,H,P), final state (B,H,P,N)),
    both fp32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    a = torch.exp(dtf * A.float())  # (B,S,H)
    if initial_state is None:
        h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    else:
        h = initial_state.float().clone()
    ys = []
    for t in range(S):
        upd = torch.einsum("bn,bhp->bhpn", Bf[:, t], xf[:, t] * dtf[:, t, :, None])
        h = h * a[:, t, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, dim=1), h


def _split(v, lo: bool = True):
    """v as two bf16 terms, hi + lo, each returned in fp32: hi = bf16(v),
    lo = bf16(v - hi) (0 where ``lo`` is False)."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float() if lo else torch.zeros_like(v)


SPLIT_OPERANDS = ("G", "h", "xw")


def ssd_scan_split_ref(x, dt, A, Bm, Cm, initial_state=None, lo_terms=SPLIT_OPERANDS):
    """The arithmetic of the CUDA kernel's ``wgmma`` variant, in plain PyTorch
    (for the tests): x, Bm, Cm read as bf16; chunks of 64 steps (a ragged S
    padded with dt = 0, which leaves the state unchanged); per chunk,
    with cs the inclusive cumulative sum of dt·A,

        G     = (C·Bᵀ) ⊙ exp(cs_q − cs_s) ⊙ dt_s   for s <= q, else 0
        y     = exp(cs_q)·(C·h_hi + C·h_lo) + G_hi·x + G_lo·x
        h     = exp(cs_L)·h + Bᵀ·(w⊙x)_hi + Bᵀ·(w⊙x)_lo,  w_s = exp(cs_L − cs_s)·dt_s

    where v_hi + v_lo is the two-term bf16 split of G, of the state h
    entering the chunk and of w⊙x; every product sums in fp32. Same
    arguments and results as ``ssd_scan_ref``. ``lo_terms`` names the
    operands that keep their lo term (all three in the kernel; the tests drop
    one to show that it is needed)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = 64
    pad = -S % chunk
    xf, Bf, Cf = (F.pad(t.bfloat16().float(), (0, 0) * (t.ndim - 2) + (0, pad))
                  for t in (x, Bm, Cm))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    Af = A.float()
    if initial_state is None:
        h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    else:
        h = initial_state.float().clone()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for t0 in range(0, S + pad, chunk):
        xc, Bc, Cc = (t[:, t0:t0 + chunk] for t in (xf, Bf, Cf))
        d = dtf[:, t0:t0 + chunk]  # (B,Q,H)
        cs = torch.cumsum(d * Af, dim=1)  # (B,Q,H)
        scores = torch.einsum("bqn,bsn->bqs", Cc, Bc)
        diff = (cs[:, :, None, :] - cs[:, None, :, :]).masked_fill(~mask[None, :, :, None],
                                                                   -math.inf)
        G = scores[..., None] * torch.exp(diff) * d[:, None, :, :]  # (B,Q,Q,H)
        g_hi, g_lo = _split(G, "G" in lo_terms)
        h_hi, h_lo = _split(h, "h" in lo_terms)
        y = (torch.einsum("bqn,bhpn->bqhp", Cc, h_hi) + torch.einsum("bqn,bhpn->bqhp", Cc, h_lo))
        y = y * torch.exp(cs)[..., None]
        y = y + torch.einsum("bqsh,bshp->bqhp", g_hi, xc) + torch.einsum("bqsh,bshp->bqhp", g_lo, xc)
        ys.append(y)
        w = torch.exp(cs[:, -1:] - cs) * d  # (B,Q,H)
        xw_hi, xw_lo = _split(w[..., None] * xc, "xw" in lo_terms)
        h = (h * torch.exp(cs[:, -1])[:, :, None, None]
             + torch.einsum("bsn,bshp->bhpn", Bc, xw_hi) + torch.einsum("bsn,bshp->bhpn", Bc, xw_lo))
    return torch.cat(ys, dim=1)[:, :S], h
