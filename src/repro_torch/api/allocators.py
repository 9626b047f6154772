"""Allocator registry: the paper's §IV resource-allocation strategies (port of
``repro/api/allocators.py``).

Each entry wraps one branch of ``core.resource_alloc.optimize`` as a named
strategy with the uniform signature

    allocate(fcfg, net, model_params=None, **kw) -> resource_alloc.Allocation

``**kw`` forwards solver knobs (``eta_search``, ``eta_grid``, ``solver``).

Registered strategies (paper Fig. 2 legend):
  proposed  η sweep + exact Lemma-3 bandwidth optimiser (problem (17))
  EB        equal bandwidth per user, optimise η
  FE        fix η = 0.1, optimise bandwidth
  BA        both fixed (the unoptimised baseline)
"""

from __future__ import annotations

from repro_torch.registry import Registry
from repro_torch.core import resource_alloc as ra

allocators: Registry = Registry("allocator")


def _wrap(strategy: str):
    def allocate(fcfg, net, model_params=None, **kw) -> ra.Allocation:
        return ra.optimize(fcfg, net, strategy, model_params=model_params, **kw)

    allocate.__name__ = f"allocate_{strategy}"
    allocate.__doc__ = f"resource_alloc.optimize(..., strategy={strategy!r})"
    return allocate


for _strategy in ("proposed", "EB", "FE", "BA"):
    allocators.register(_strategy)(_wrap(_strategy))


def get_allocator(name: str):
    return allocators.get(name)
