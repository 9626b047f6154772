"""Hierarchical network topologies, multi-hop client→edge→cloud graphs (port
of ``repro/net``).

``topology`` defines the :class:`Topology` protocol and the name registry —
``star`` (the flat FedsLLM default) | ``edge-cloud`` | ``edge-agg`` |
``relay`` — the 5th pluggable strategy axis;
``delay`` composes per-hop times into an end-to-end critical-path
``RoundTiming``; ``allocation`` solves the paper's (16)/(17) per edge cell
(independent convex subproblems at fixed η, topology-level η sweep).
"""

# allocation/delay first: topology imports them from this package, so they
# must already be bound when a caller lands on repro_torch.net.topology directly
from repro_torch.net import allocation, delay
from repro_torch.net.delay import HierRoundTiming
from repro_torch.net.topology import (Topology, get_topology, topologies)

__all__ = ["Topology", "get_topology", "topologies", "HierRoundTiming",
           "allocation", "delay"]
