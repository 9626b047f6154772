"""The precision control: the reference computed one step below the
configuration's bfloat16, its products' operands rounded to float8 (e4m3,
one scale per tensor, as a float8 matmul takes them) and accumulated in
float32."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 at a per-tensor scale that maps its largest
    magnitude to the format's largest, and back to t's type."""
    amax = t.abs().amax().float().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)


QUANT = {"fp8": fp8_e4m3}
