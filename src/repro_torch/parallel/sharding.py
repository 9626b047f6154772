"""Logical-axis sharding rules (port of ``repro/parallel/sharding.py``).

Model code of the reference names the axes of its parameters and
activations ("batch", "embed", "heads", ...); a rule set maps each logical
name to mesh axes per shape kind (train / prefill / decode), keeping the
longest prefix whose product divides the dim. ``RULESETS`` is the
reference's, copied verbatim (its rationale is the TPU pod's: FSDP over
``data``, tensor parallelism over ``model``).

``spec_for`` is the reference's spec math, returning a plain tuple laid out
as ``PartitionSpec``'s. On the port's one-card mesh (``launch/mesh.py``)
every axis has size 1, so every spec places the whole tensor on that card
and ``shard`` is the identity; the specs still say how the reference's pod
would cut each tensor (``launch/steps.py``'s ``batch_shardings`` and
``cache_shardings``).

Not ported: ``ParamLeaf``, ``make_param(abstract=)``, ``split_param_tree``
and ``named_sharding_tree``. The port's parameters carry no logical axes
(``models/layers.py``'s ``make_param`` draws values only), and one card
shards nothing, so they would be dead code.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence

# ---------------------------------------------------------------------------
# Rule sets: logical axis -> tuple of mesh axes (tried in order, longest
# divisible prefix wins).  "pod" entries are dropped automatically when the
# mesh has no pod axis.
# ---------------------------------------------------------------------------

Rules = dict[str, tuple[str, ...]]

RULESETS: dict[str, Rules] = {
    "train": {
        "batch": ("pod", "data"),
        "seq": (),
        "kv_seq": (),
        "embed": ("data",),          # FSDP axis
        "embed_pod": ("pod", "data"),  # FSDP over pod too (multi-pod weights)
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        "expert_embed": ("data",),   # MoE weight D dim stays 2-D sharded
        "layers": (),
        "rank": (),                  # LoRA rank — tiny, never shard
        "state": (),                 # SSM state dim
        "conv": (),
    },
    "prefill": {
        "batch": ("pod", "data"),
        "seq": ("model",),           # sequence parallelism for 32k prefill
        "kv_seq": ("model",),
        "embed": ("data",),
        "embed_pod": ("pod", "data"),
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        "expert_embed": ("data",),
        "layers": (),
        "rank": (),
        "state": (),
        "conv": (),
    },
    "decode": {
        "batch": ("pod", "data"),
        "seq": (),
        "kv_seq": ("model",),        # flash-decode: cache length sharded
        "embed": (),                 # weight-stationary: dense weights fit via
                                     # TP; FSDP gathers per token dominated
                                     # decode ICI (§Perf iter 7)
        "embed_pod": (),
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        "expert_embed": ("data",),   # 235B-class MoE can't fit TP-only
        "layers": (),
        "rank": (),
        "state": (),
        "conv": (),
    },
}


def activation_rules(kind: str) -> Rules:
    return RULESETS[kind]


# ---------------------------------------------------------------------------
# Active sharding context (mesh + rules), per thread.
# ---------------------------------------------------------------------------


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[Rules] = None


_CTX = _Ctx()


def set_context(mesh, rules: Optional[Rules]) -> None:
    _CTX.mesh = mesh
    _CTX.rules = rules


def active_context() -> tuple[Any, Optional[Rules]]:
    return _CTX.mesh, _CTX.rules


@contextlib.contextmanager
def sharding_context(mesh, rules: Optional[Rules]):
    prev = active_context()
    set_context(mesh, rules)
    try:
        yield
    finally:
        set_context(*prev)


# ---------------------------------------------------------------------------
# Spec computation with divisibility fallback
# ---------------------------------------------------------------------------


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]], rules: Rules,
             mesh) -> tuple:
    """The spec of an array of ``shape`` with logical ``axes``, laid out as
    ``PartitionSpec``'s entries: per dim None, a mesh axis name or a tuple of
    them. Each logical axis maps through ``rules`` to mesh axes; the longest
    prefix whose product divides the dim is kept; no mesh axis is used by
    two dims; trailing Nones are stripped."""
    sizes = dict(mesh.shape)
    used: set[str] = set()
    out: list[Any] = []
    for dim, ax in zip(shape, axes):
        if ax is None or ax not in rules:
            out.append(None)
            continue
        mesh_axes = [a for a in rules[ax] if a in sizes and a not in used]
        chosen: list[str] = []
        prod = 1
        for a in mesh_axes:
            if dim % (prod * sizes[a]) == 0:
                chosen.append(a)
                prod *= sizes[a]
            else:
                break
        if not chosen:
            out.append(None)
        elif len(chosen) == 1:
            out.append(chosen[0])
            used.add(chosen[0])
        else:
            out.append(tuple(chosen))
            used.update(chosen)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def shard(x, axes: Sequence[Optional[str]]):
    """Annotate ``x`` with logical axes: the identity. Under a one-card mesh
    every spec places the whole tensor on that card, and outside a context
    there is nothing to place."""
    return x
