"""Generic named-strategy registry (the port's copy of ``repro/registry.py``).

One mechanism backs every pluggable axis (aggregators, local algorithms, and
later allocators and compressors), mirroring ``config.register_arch``:
strategies register themselves by name at import time, lookups of unknown
names raise a ``KeyError`` that lists the known names.
"""

from __future__ import annotations

from typing import Callable, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        """Decorator: ``@registry.register("name")`` on a strategy."""

        def deco(obj: T) -> T:
            if name in self._entries:
                raise ValueError(f"duplicate {self.kind} {name!r}")
            self._entries[name] = obj
            return obj

        return deco

    def get(self, name: str) -> T:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {sorted(self._entries)}")
        return self._entries[name]

    def names(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries
