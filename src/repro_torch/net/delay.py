"""Per-hop delay composition for hierarchical topologies (port of
``repro/net/delay.py``).

Extends :class:`repro_torch.core.fedsllm.RoundTiming` — the §III per-client round
time (compute + fed uplink + per-iteration main uplink) — with the backhaul
hop a multi-hop graph adds: each client's end-to-end round time is the
critical path through its own route,

    total_k = compute_k + t_c,k + V·t_s,k + backhaul_{edge(k)}

and the round's wall-clock stays the max over clients of that per-path
total, so deadline straggler masks and the campaign's simulated clock work
unchanged on the richer timing object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.fedsllm import RoundTiming


@dataclass
class HierRoundTiming(RoundTiming):
    """RoundTiming plus the backhaul/downlink hops of each client's path.

    ``total`` already includes ``backhaul`` (and ``downlink`` when the
    broadcast term is enabled) — critical-path composed; the extra fields
    keep the per-hop breakdown inspectable for reporting.
    """

    backhaul: np.ndarray = None  # (K,) backhaul seconds on each client's path
    edge_of: Optional[np.ndarray] = None  # (K,) edge index per client
    downlink: Optional[np.ndarray] = None  # (K,) broadcast seconds (or None)


def compose(wireless: RoundTiming, backhaul_k: np.ndarray,
            assign: Optional[np.ndarray],
            downlink_k: Optional[np.ndarray] = None) -> HierRoundTiming:
    """Compose the wireless hop with per-client backhaul/downlink hops.

    ``backhaul_k`` is already expanded to (K,) — each client carries the
    backhaul time of the edge it is attached to.  Under the legacy serial
    pipe all of a cell's traffic shares it, so every member waits for the
    full cell transfer; under the queueing models
    (``HierTopology(backhaul_model="fifo" | "ps")``) it is each client's
    own wait+service in the SHARED metro queue.  ``downlink_k`` (optional)
    adds the per-round global-model broadcast cost — one multicast
    transmission per cell, every member pays the same wait
    (``repro_torch.des.queueing.broadcast_seconds``).
    """
    backhaul_k = np.asarray(backhaul_k, float)
    total = wireless.total + backhaul_k
    if downlink_k is not None:
        downlink_k = np.asarray(downlink_k, float)
        total = total + downlink_k
    return HierRoundTiming(
        compute=wireless.compute,
        uplink_fed=wireless.uplink_fed,
        uplink_main=wireless.uplink_main,
        total=total,
        backhaul=backhaul_k,
        edge_of=None if assign is None else np.asarray(assign),
        downlink=downlink_k,
    )
