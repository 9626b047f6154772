"""Plain PyTorch version of the SSD scan (after ``repro/kernels/ssd_ref.py``):
the exact sequential recurrence

    h_t = exp(dt_t·A)·h_{t-1} + dt_t·(x_t ⊗ B_t),    y_t = h_t·C_t

extended with an initial state and the final state, as the model's prefill
needs them; ``ssd_scan_split_ref``, the chunked arithmetic of the CUDA
kernel's ``wgmma`` variant (two-term bf16 splits), and
``ssd_scan_tf32x3_ref``, that of its ``tf32`` variant (3xTF32), for the
tests, each with the kernel's split of N (``ssd_scan.n_slices``): a partial
y per slice of N, the partials added in slice order."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.attn_ref import split_tf32
from repro_torch.kernels.ssd_scan import slice_width


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


def _slices(N: int, width: int | None):
    """The kernel's slices of N's columns (``ssd_scan.slice_width``; one,
    the whole of N, up to 256), or slices of ``width`` columns."""
    width = width or slice_width(N)
    return [slice(n0, min(n0 + width, N)) for n0 in range(0, N, width)]


def _add(parts):
    """The partials added in slice order, as the kernel's second launch adds
    them (one slice: itself)."""
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    return y


def _chunks(x, dt, Bm, Cm, initial_state, read):
    """Chunks of 64 steps (a ragged S padded with dt = 0, which leaves the
    state unchanged): each chunk's x, B, C (as ``read`` gives them) and dt;
    the state to start from; the causal mask of a chunk."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = 64
    pad = -S % chunk
    xf, Bf, Cf = (F.pad(read(t), (0, 0) * (t.ndim - 2) + (0, pad)) for t in (x, Bm, Cm))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    if initial_state is None:
        h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    else:
        h = initial_state.float().clone()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    steps = [tuple(t[:, t0:t0 + chunk] for t in (xf, Bf, Cf, dtf))
             for t0 in range(0, S + pad, chunk)]
    return steps, h, mask


def _decays(d, A, mask):
    """A chunk's cs (the inclusive cumulative sum of dt·A, (B,Q,H)) and
    exp(cs_q − cs_s) for s <= q, else 0 ((B,Q,Q,H))."""
    cs = torch.cumsum(d * A.float(), dim=1)
    diff = (cs[:, :, None, :] - cs[:, None, :, :]).masked_fill(~mask[None, :, :, None],
                                                               -math.inf)
    return cs, torch.exp(diff)


def ssd_scan_split_ref(x, dt, A, Bm, Cm, initial_state=None, lo_terms=SPLIT_OPERANDS,
                       width=None):
    """The arithmetic of the CUDA kernel's ``wgmma`` variant, in plain PyTorch
    (for the tests): x, Bm, Cm read as bf16; chunks of 64 steps (a ragged S
    padded with dt = 0, which leaves the state unchanged); per chunk, with
    cs the inclusive cumulative sum of dt·A, and per slice of N's columns
    (C, B and h the slice's),

        G     = (C·Bᵀ) ⊙ exp(cs_q − cs_s) ⊙ dt_s   for s <= q, else 0
        y_sl  = exp(cs_q)·(C·h_hi + C·h_lo) + G_hi·x + G_lo·x
        h     = exp(cs_L)·h + Bᵀ·(w⊙x)_hi + Bᵀ·(w⊙x)_lo,  w_s = exp(cs_L − cs_s)·dt_s

    where v_hi + v_lo is the two-term bf16 split of G, of the state h
    entering the chunk and of w⊙x; every product sums in fp32, and y is the
    slices' y_sl added in slice order. Same arguments and results as
    ``ssd_scan_ref``. ``lo_terms`` names the operands that keep their lo term
    (all three in the kernel; the tests drop one to show that it is needed);
    ``width``: a slice's columns (the kernel's ``slice_width`` by default;
    N itself: one slice)."""
    S, N = x.shape[1], Bm.shape[-1]
    steps, h, mask = _chunks(x, dt, Bm, Cm, initial_state, lambda t: t.bfloat16().float())
    ys = []
    for xc, Bc, Cc, d in steps:
        cs, decay = _decays(d, A, mask)
        w = torch.exp(cs[:, -1:] - cs) * d  # (B,Q,H)
        xw_hi, xw_lo = _split(w[..., None] * xc, "xw" in lo_terms)
        parts, states = [], []
        for sl in _slices(N, width):
            Cs, Bs, hs = Cc[..., sl], Bc[..., sl], h[..., sl]
            G = torch.einsum("bqn,bsn->bqs", Cs, Bs)[..., None] * decay * d[:, None]
            g_hi, g_lo = _split(G, "G" in lo_terms)
            h_hi, h_lo = _split(hs, "h" in lo_terms)
            y = (torch.einsum("bqn,bhpn->bqhp", Cs, h_hi)
                 + torch.einsum("bqn,bhpn->bqhp", Cs, h_lo))
            y = y * torch.exp(cs)[..., None]
            parts.append(y + torch.einsum("bqsh,bshp->bqhp", g_hi, xc)
                         + torch.einsum("bqsh,bshp->bqhp", g_lo, xc))
            states.append(hs * torch.exp(cs[:, -1])[:, :, None, None]
                          + torch.einsum("bsn,bshp->bhpn", Bs, xw_hi)
                          + torch.einsum("bsn,bshp->bhpn", Bs, xw_lo))
        ys.append(_add(parts))
        h = torch.cat(states, dim=-1) if len(states) > 1 else states[0]
    return torch.cat(ys, dim=1)[:, :S], h


TF32_OPERANDS = ("C", "B", "h", "G", "x", "xw")


def ssd_scan_tf32x3_ref(x, dt, A, Bm, Cm, initial_state=None, terms=TF32_OPERANDS,
                        width=None):
    """The arithmetic of the CUDA kernel's ``tf32`` variant (fp32 x, Bm, Cm),
    in plain PyTorch (for the tests): chunks of 64 steps (a ragged S padded
    with dt = 0); per chunk, with cs the inclusive cumulative sum of dt·A,
    per slice of N's columns (C, B and h the slice's) and every product in
    3xTF32 (each fp32 operand split into a TF32 big and small term,
    ``attn_ref.split_tf32``; a·b = a_s·b_b + a_b·b_s + a_b·b_b),

        scores = C·Bᵀ,   y_sl = exp(cs_q)·(C·hᵀ) + G·x,
        G      = scores ⊙ exp(cs_q − cs_s) ⊙ dt_s   for s <= q, else 0
        h      = exp(cs_L)·h + (Bᵀ·(w⊙x))ᵀ,  w_s = exp(cs_L − cs_s)·dt_s

    where h is the state entering the chunk and the update Bᵀ·(w⊙x) is summed
    from zero and added to the decayed state in fp32; y is the slices' y_sl
    added in slice order. Same arguments and results as ``ssd_scan_ref``.
    ``terms`` names the operands whose small term is kept (all six in the
    kernel; the tests drop one to show that it is needed); ``width`` as
    ``ssd_scan_split_ref`` takes it."""
    S, N = x.shape[1], Bm.shape[-1]
    steps, h, mask = _chunks(x, dt, Bm, Cm, initial_state, lambda t: t.float())

    def mul(eq, a, b, a_name, b_name):
        (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
        out = torch.einsum(eq, ab, bb)
        if a_name in terms:
            out = out + torch.einsum(eq, as_, bb)
        if b_name in terms:
            out = out + torch.einsum(eq, ab, bs)
        return out

    ys = []
    for xc, Bc, Cc, d in steps:
        cs, decay = _decays(d, A, mask)
        w = torch.exp(cs[:, -1:] - cs) * d  # (B,Q,H)
        parts, states = [], []
        for sl in _slices(N, width):
            Cs, Bs, hs = Cc[..., sl], Bc[..., sl], h[..., sl]
            G = mul("bqn,bsn->bqs", Cs, Bs, "C", "B")[..., None] * decay * d[:, None]
            y = mul("bqn,bhpn->bqhp", Cs, hs, "C", "h") * torch.exp(cs)[..., None]
            parts.append(y + mul("bqsh,bshp->bqhp", G, xc, "G", "x"))
            states.append(hs * torch.exp(cs[:, -1])[:, :, None, None]
                          + mul("bsn,bshp->bhpn", Bs, w[..., None] * xc, "B", "xw"))
        ys.append(_add(parts))
        h = torch.cat(states, dim=-1) if len(states) > 1 else states[0]
    return torch.cat(ys, dim=1)[:, :S], h
