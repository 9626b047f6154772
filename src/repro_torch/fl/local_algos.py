"""Local-update algorithms (port of ``repro/fl/local_algos.py``): the
client's step on problem (4) inside the round.

  ``gd``        the paper's plain GD on problem (4), the default
                (``correct`` is the identity)
  ``fedprox``   FedProx (Li et al., MLSys'20): the proximal term (μ/2)‖h‖²
                against the broadcast global adapters, i.e. ∇G + μ·h;
                μ = 0 is ``gd``
  ``scaffold``  SCAFFOLD (Karimireddy et al., ICML'20) option II: each local
                step is corrected by control variates, ∇G − c_k + c̄, and
                after the round's I_loc steps c_k⁺ = c_k − c̄ − h/(I_loc·δ).
                The (K, …) variates are round-function state, carried by the
                caller across rounds.

Unknown names raise ``KeyError`` listing the known ones.
"""

from __future__ import annotations

from typing import Union

from repro_torch.registry import Registry
from repro_torch.tree import tree_map, weak

local_algos: Registry = Registry("local_algo")


class LocalAlgo:
    """Strategy protocol for the client's local-update rule.

    ``correct(g, h, ctrl, ctrl_bar)`` transforms the problem-(4) gradient
    ``g`` (an ``(h_c, h_s)``-shaped tree) before the ``h ← h − δ·g`` step;
    ``h`` is the current local deviation, ``ctrl``/``ctrl_bar`` the client's
    control variate and the population mean (None for stateless algorithms).

    ``stateful`` algorithms carry per-client variates: a ``(K, …)``-stacked
    tree shaped like the adapters, made by :meth:`init_variates` and advanced
    once a round by :meth:`update_variates` (masked clients keep theirs).
    """

    name = "base"
    stateful = False

    def params(self) -> dict:
        return {}

    def correct(self, g, h, ctrl, ctrl_bar):
        """Transformed gradient for the ``h ← h − δ·(·)`` local step."""
        return g

    def init_variates(self, template, num_clients: int):
        """Fresh per-client variates ``(num_clients, …)`` stacked like
        ``template`` (the global adapters), or None when stateless."""
        return None

    def update_variates(self, variates, ctrl_bar, h, mask, I_loc: int, delta: float):
        """Post-round variate update of the cohort's rows."""
        return variates


@local_algos.register("gd")
class GDLocal(LocalAlgo):
    """The paper's plain gradient descent on problem (4) (eq. 9)."""

    name = "gd"


@local_algos.register("fedprox")
class FedProxLocal(LocalAlgo):
    """FedProx: ∇G + μ·h, the proximal pull towards the broadcast adapters
    (``h`` is already the deviation from them)."""

    name = "fedprox"

    def __init__(self, mu: float = 0.1):
        self.mu = float(mu)

    def params(self) -> dict:
        return {"mu": self.mu}

    def correct(self, g, h, ctrl, ctrl_bar):
        return tree_map(lambda gx, hx: gx + weak(self.mu, hx) * hx, g, h)


@local_algos.register("scaffold")
class ScaffoldLocal(LocalAlgo):
    """SCAFFOLD option II: h ← h − δ·(∇G(h) − c_k + c̄), then
    c_k⁺ = c_k − c̄ − h/(I_loc·δ). c̄ is the mean of the stored variates of
    all K users; variates start at zero, so round 0 equals ``gd``."""

    name = "scaffold"
    stateful = True

    def init_variates(self, template, num_clients: int):
        return tree_map(lambda x: x.new_zeros((num_clients,) + tuple(x.shape)), template)

    def correct(self, g, h, ctrl, ctrl_bar):
        return tree_map(lambda gx, ck, cb: gx - ck + cb, g, ctrl, ctrl_bar)

    def update_variates(self, variates, ctrl_bar, h, mask, I_loc: int, delta: float):
        inv = 1.0 / (float(I_loc) * float(delta))
        new = tree_map(lambda ck, cb, hk: ck - cb[None] - weak(inv, hk) * hk,
                       variates, ctrl_bar, h)
        if mask is None:
            return new

        def blend(old, upd):  # stragglers keep their old variates
            m = mask.reshape((-1,) + (1,) * (upd.ndim - 1)).to(upd.dtype)
            return m * upd + (1.0 - m) * old

        return tree_map(blend, variates, new)


def get_local_algo(spec: Union[str, LocalAlgo, type], **kw) -> LocalAlgo:
    """A local algorithm by name (with its kwargs), class or instance."""
    if isinstance(spec, LocalAlgo):
        if kw:
            raise TypeError("pass kwargs with a name, not an instance")
        return spec
    if isinstance(spec, type) and issubclass(spec, LocalAlgo):
        return spec(**kw)
    return local_algos.get(spec)(**kw)

