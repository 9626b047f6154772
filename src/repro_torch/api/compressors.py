"""Uplink compressor registry: codecs for the smashed-activation uplink (port
of ``repro/api/compressors.py``).

The paper charges a fixed ``s`` bits per smashed-activation upload (eq. (15)
via ``FedsLLMConfig.s_bits``). A ``Compressor`` makes that volume a property
of the chosen codec: ``Experiment`` rescales ``s_bits`` by the codec's
``ratio`` before running the allocator (so the delay model sees the smaller
uplink), and the split engine applies the codec to the activations
straight-through (``core.split.split_value_and_grad(compressor=...)``), so
training sees the codec's quantisation error too.

Entries are *factories*: ``get_compressor("topk", fraction=0.05)`` builds a
configured instance.

Registered codecs:
  none   identity (paper-faithful, ratio 1)
  int8   per-tensor absmax int8 quantisation (ratio 8/32 vs float32), the
         recommended lossy activation codec
  randk  fixed pseudorandom coordinate subsampling (seed-reproducible, so no
         index bits on the wire). The mask is constant across local
         iterations, making the codec a *linear* channel: FEDL's surrogate
         ∇F_k(Δw+h) − ∇F_k(Δw) stays consistent and local GD is stable.
  topk   magnitude top-k sparsification, values + packed indices. WARNING:
         the data-dependent mask flips between local iterations, which
         breaks the surrogate's gradient-difference cancellation and can
         diverge local GD. Appropriate for one-shot update uploads, not the
         inner training loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Protocol, runtime_checkable

import torch

from repro_torch.core import compression
from repro_torch.registry import Registry


@runtime_checkable
class Compressor(Protocol):
    """Lossy straight-through codec for tensors on the uplink."""

    name: str

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Compress→decompress round-trip (shape-preserving)."""
        ...

    def bits(self, nelems: int, dense_bits: int = 32) -> float:
        """Uplink volume in bits for a tensor of ``nelems`` elements."""
        ...

    @property
    def ratio(self) -> float:
        """Nominal compressed/dense volume ratio, used to rescale the delay
        model's ``s_bits`` before the allocator runs."""
        ...


compressors: Registry = Registry("compressor")

# nominal tensor size used to price top-k index bits in ``ratio`` (the exact
# per-tensor volume comes from ``bits``)
_NOMINAL_ELEMS = 1 << 20


@compressors.register("none")
@dataclass(frozen=True)
class NoneCompressor:
    """Identity codec: the paper's uncompressed uplink."""

    name: str = "none"

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def bits(self, nelems: int, dense_bits: int = 32) -> float:
        return float(nelems * dense_bits)

    @property
    def ratio(self) -> float:
        return 1.0


@compressors.register("int8")
@dataclass(frozen=True)
class Int8Compressor:
    """Per-tensor absmax int8 quantisation (8 value bits + one f32 scale)."""

    name: str = "int8"

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        q, scale = compression.quantize_int8(x)
        return compression.dequantize_int8(q, scale, dtype=x.dtype)

    def bits(self, nelems: int, dense_bits: int = 32) -> float:
        return float(nelems * 8 + 32)

    @property
    def ratio(self) -> float:
        return 8.0 / 32.0


@lru_cache(maxsize=8)
def _randk_mask(seed: int, fraction: float, shape: tuple, device: torch.device) -> torch.Tensor:
    """The keep mask of ``randk``: drawn on the CPU from ``seed`` (so every
    device gets the same mask), then moved to ``device``. The reference draws
    it with ``jax.random.bernoulli``, which torch cannot reproduce: the law
    (keep with probability ``fraction``) is the same, the coordinates are not."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=gen) < fraction).to(device)


@compressors.register("randk")
@dataclass(frozen=True)
class RandKCompressor:
    """Fixed pseudorandom keep-``fraction`` coordinate mask.

    Both ends derive the mask from the shared ``seed``, so only the kept
    values travel (no index bits). Because the mask is data-independent and
    constant across local iterations, the codec is a fixed linear projection,
    safe inside FEDL's local GD loop, unlike ``topk``."""

    fraction: float = 0.5
    seed: int = 0
    value_bits: int = 32
    name: str = "randk"

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        mask = _randk_mask(self.seed, self.fraction, tuple(x.shape), x.device)
        return x * mask.to(x.dtype)

    def bits(self, nelems: int, dense_bits: int = 32) -> float:
        k = max(1, int(math.ceil(self.fraction * nelems)))
        return float(k * self.value_bits + 32)  # values + the shared seed

    @property
    def ratio(self) -> float:
        return self.fraction * self.value_bits / 32.0


@compressors.register("topk")
@dataclass(frozen=True)
class TopKCompressor:
    """Keep the top-``fraction`` entries by magnitude; charge value+index bits.

    WARNING: data-dependent masking is discontinuous across local iterations
    and can diverge FEDL's local GD when used on activations (see the module
    docstring); prefer ``int8``/``randk`` there."""

    fraction: float = 0.1
    value_bits: int = 32
    name: str = "topk"

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x * compression.topk_mask(x, self.fraction)

    def bits(self, nelems: int, dense_bits: int = 32) -> float:
        k = max(1, int(math.ceil(self.fraction * nelems)))
        index_bits = max(1, math.ceil(math.log2(max(nelems, 2))))
        return float(k * (self.value_bits + index_bits))

    @property
    def ratio(self) -> float:
        return self.bits(_NOMINAL_ELEMS) / (_NOMINAL_ELEMS * 32.0)


def get_compressor(name: str, **kw) -> Compressor:
    """Build a configured codec: ``get_compressor("topk", fraction=0.05)``."""
    return compressors.get(name)(**kw)
