"""The port's kernel libraries that a traced part counts and the roofline
metrics read, one file each (``<library>.py``), found by listing this folder.

Each file gives ``KERNEL``, the pattern of its kernels' names as the
profiler records them; ``launches()``, the program's counter of its
launches; ``shapes(cfg, B, S)``, its launches in one forward pass of B
sequences of S tokens of a configuration (None where it cannot tell); and
``work(shape)``, one launch's bytes and operations. A later library is a new
file here, and its roofline a new metric file that names it.
"""

from __future__ import annotations

import importlib
from pathlib import Path


def names() -> list[str]:
    return sorted(p.stem for p in Path(__file__).parent.glob("*.py") if p.stem != "__init__")


def get(name: str):
    return importlib.import_module(f"portbench.libraries.{name}")


def load() -> dict:
    return {name: get(name) for name in names()}
