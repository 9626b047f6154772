"""The check that a run loaded nothing of JAX or of the JAX package."""

from __future__ import annotations

import sys

# compared whole with each loaded module's top-level name: the port,
# ``repro_torch``, begins with the JAX package's name ``repro``
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
