"""Plain PyTorch version of the SSD scan (after ``repro/kernels/ssd_ref.py``):
the exact sequential recurrence

    h_t = exp(dt_t·A)·h_{t-1} + dt_t·(x_t ⊗ B_t),    y_t = h_t·C_t

extended with an initial state and the final state, as the model's prefill
needs them."""

from __future__ import annotations

import torch


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
