"""The one-card mesh (port of ``repro/launch/mesh.py``).

A ``Mesh`` is a shape, its axis names and the devices it holds; the spec
math of ``parallel/sharding.py`` reads only the axis sizes. The port runs on
one card, so a mesh holds at most one device: ``make_mesh`` and
``make_host_mesh`` build that mesh, and a mesh over more devices raises
``NotImplementedError``. ``make_abstract_mesh`` holds no device at all and
takes any shape, as the reference's ``AbstractMesh`` does, for spec math.

``make_production_mesh`` (the reference's 16 x 16 TPU pod, 2 x 16 x 16 with
two pods) has no counterpart: it is a multi-card mesh, and waits for a cell
of four cards that asks for it.

Nothing here touches a device at import: the meshes are made by functions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device

SINGLE_CARD = "the port runs on one card"


@dataclass(frozen=True)
class Mesh:
    """Axis sizes by name, and the devices laid out in that shape (none for
    an abstract mesh)."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]
    devices: tuple[torch.device, ...] = ()

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.axis_sizes} and axes {self.axis_names} "
                             f"differ in rank")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_abstract_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """A device-less mesh of any shape, for spec math."""
    return Mesh(tuple(int(s) for s in shape), tuple(axes))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``device``; every axis must be 1 (one card)."""
    mesh = make_abstract_mesh(shape, axes)
    if mesh.size != 1:
        raise NotImplementedError(f"a mesh of {mesh.size} devices {mesh.shape}: {SINGLE_CARD}")
    return Mesh(mesh.axis_sizes, mesh.axis_names, (resolve_device(device),))


def make_host_mesh(device="cuda") -> Mesh:
    """The devices present as a 1-D ``("data",)`` mesh: the one card (or,
    asked for, the CPU)."""
    return make_mesh((1,), ("data",), device)
