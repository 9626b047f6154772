"""Back-compat re-export (port of ``repro/api/registry.py``): the generic
Registry lives in ``repro_torch.registry``.

The scenario axis lives in ``repro_torch.sim`` (which ``repro_torch.api``
imports), so the registry mechanism itself sits below both packages to stay
free of import cycles; ``repro_torch.api.registry`` imports keep working.
"""

from repro_torch.registry import Registry

__all__ = ["Registry"]
