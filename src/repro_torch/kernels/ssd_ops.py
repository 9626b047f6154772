"""Public wrapper of the SSD chunked scan (after ``repro/kernels/ssd_ops.py``).

A tensor on the CPU goes to the plain version (the exact sequential
recurrence); a CUDA tensor launches one of the CUDA kernel's variants
(``wgmma`` or ``fma``, picked by ``variant`` of ``ssd_scan.py`` from shapes,
dtypes, strides and pointers before the launch) or raises. Unlike the
reference wrapper, a ragged S is masked inside the kernel (no padded copies),
an initial state goes in and the final state comes out, and y is fp32.
``ssd_scan.launches`` counts kernel launches, ``ssd_scan.variant_launches``
counts them by variant. Forward-only: with grad mode on, an input
that requires grad raises (``kernels.require_no_grad``), on every device."""

from __future__ import annotations

import torch

from repro_torch.kernels import require_no_grad
from repro_torch.kernels.ssd_ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan import MAX_SMEM, smem_bytes, ssd_scan_cuda, variant


def _check(x, dt, A, Bm, Cm, initial_state):
    if not (x.ndim == 4 and dt.ndim == 3 and A.ndim == 1 and Bm.ndim == Cm.ndim == 3):
        raise ValueError(f"ssd_scan: bad ranks x{tuple(x.shape)} dt{tuple(dt.shape)} "
                         f"A{tuple(A.shape)} Bm{tuple(Bm.shape)} Cm{tuple(Cm.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape != (B, S, N) or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: shapes do not match x{tuple(x.shape)}: dt{tuple(dt.shape)} "
                         f"A{tuple(A.shape)} Bm{tuple(Bm.shape)} Cm{tuple(Cm.shape)}")
    if 0 in (B, S, H, P, N):
        raise ValueError(f"ssd_scan: empty input x{tuple(x.shape)} Bm{tuple(Bm.shape)}")
    if initial_state is not None and initial_state.shape != (B, H, P, N):
        raise ValueError(f"ssd_scan: initial_state{tuple(initial_state.shape)} is not "
                         f"{(B, H, P, N)}")
    tensors = [x, dt, A, Bm, Cm] + ([initial_state] if initial_state is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ssd_scan: tensors on different devices")
    if not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"ssd_scan: mixed dtypes x {x.dtype}, Bm {Bm.dtype}, Cm {Cm.dtype}")
    if x.device.type == "cuda":
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"ssd_scan: the CUDA kernel takes bfloat16 or float32 x/Bm/Cm, "
                            f"got {x.dtype}")
        if any(t.dtype != torch.float32 for t in tensors[1:3] + tensors[5:]):
            raise TypeError("ssd_scan: the CUDA kernel takes dt, A and initial_state in float32")
        if x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
            raise ValueError("ssd_scan: the last dims of x, Bm and Cm must be contiguous")
        if dt.stride(-1) != 1 or not A.is_contiguous():
            raise ValueError("ssd_scan: dt's last dim and A must be contiguous")
        if initial_state is not None and not initial_state.is_contiguous():
            raise ValueError("ssd_scan: initial_state must be contiguous")
    elif x.device.type != "cpu":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")


def ssd_scan(x, dt, A, Bm, Cm, *, initial_state=None):
    """x (B,S,H,P); dt (B,S,H); A (H,) (negative); Bm/Cm (B,S,N) shared by the
    heads; initial_state (B,H,P,N) or None (zeros). Returns (y (B,S,H,P),
    final state (B,H,P,N)), both fp32. The result does not depend on a chunk
    length, so none is taken: the kernel picks its own."""
    _check(x, dt, A, Bm, Cm, initial_state)
    require_no_grad("ssd_scan", x, dt, A, Bm, Cm, initial_state)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, initial_state)
    P, N = x.shape[-1], Bm.shape[-1]
    kind = variant(x.dtype, P, N, [*x.stride()[:3], *Bm.stride()[:2], *Cm.stride()[:2]],
                   [t.data_ptr() for t in (x, Bm, Cm)])
    if smem_bytes(kind, P, N) > MAX_SMEM:
        raise ValueError(f"ssd_scan: P={P}, N={N} need {smem_bytes(kind, P, N)} bytes of "
                         f"shared memory ({kind} variant), more than a block's {MAX_SMEM}")
    out = ssd_scan_cuda(x, dt, A, Bm, Cm, initial_state, kind)
    ssd_scan.launches += 1
    ssd_scan.variant_launches[kind] += 1
    return out


ssd_scan.launches = 0
ssd_scan.variant_launches = {"wgmma": 0, "fma": 0}

__all__ = ["ssd_scan", "ssd_scan_ref"]
