"""Hierarchical network topologies, the 5th pluggable strategy axis (port of
``repro/net/topology.py``: the same numpy code, so the same attachments,
timings and digests).

The paper's §IV system model is a *star*: every client has a direct wireless
link to one main server and one federated server sharing a single bandwidth
pool.  Follow-on deployments (SplitLLM's hierarchical split over wireless,
arXiv 2501.13318; edge-assisted SFL, arXiv 2504.14667) are *multi-hop*:
clients reach an edge server over wireless, edges reach the cloud over
backhaul, and aggregation can happen at both tiers.  This module makes that
graph a first-class :class:`Topology`, registered by name like the other
four axes (aggregators / allocators / compressors / scenarios):

  ``star``        the legacy flat FedsLLM graph (the default, bit-identical
                  to the pre-topology engine — no attachment, no backhaul)
  ``edge-cloud``  K clients → M edge servers → 1 cloud: the edge hosts the
                  server subnetwork (split-learning peer), the cloud hosts
                  the federated aggregator; every client's per-round fed
                  traffic transits its edge's backhaul link
  ``edge-agg``    like ``edge-cloud`` but the edge also pre-aggregates its
                  clients' LoRA deltas before the backhaul hop (two-tier
                  fedavg): the backhaul carries ONE delta per edge, and the
                  in-trace aggregation runs per edge then across edges
  ``relay``       clients sit behind relay nodes: the relay forwards ALL of
                  its clients' traffic (fed upload + per-iteration smashed
                  activations) over one shared uplink pipe

A topology owns three things:

  (a) *attachment* — which edge each client hangs off, by path loss against
      deterministic edge positions (a ring inside the cell), recomputed from
      each round's large-scale state so mobility (the ``drift`` scenario)
      re-attaches clients as they move;
  (b) *per-hop delay* — the wireless hop reuses the §III rate model against
      the client's **attached edge** (each edge owns an independent copy of
      the bandwidth pool — spatial reuse), the backhaul hop is a configured
      capacity; both compose into an end-to-end ``RoundTiming`` via the
      max-over-paths critical path (``repro_torch.net.delay``);
  (c) *allocation* — problems (16)/(17) solved **per edge cell**: at fixed η
      each cell's bandwidth pool is an independent convex subproblem for the
      existing Lemma-3 machinery; a topology-level η sweep combines the
      cells under the hierarchical critical path (``repro_torch.net.allocation``).

Everything here is host-side numpy (the simulator).  The only thing that
crosses into the round function is the one-hot assignment matrix of the
``edge-agg`` two-tier aggregation — like the straggler mask, it varies per
round in value only.

    topo = get_topology("edge-agg")
    net, assign = topo.localize(fcfg, get_scenario("geo-blockfade")
                                .initial_network(fcfg, seed))
    alloc = topo.allocate(fcfg, net, assign, get_allocator("proposed"),
                          strategy="proposed", eta_search="coarse")
    timing = topo.round_timing(fcfg, net, alloc, alloc.eta, assign)

Non-star topologies need a geometry-carrying scenario (``geo-blockfade``,
``drift``, ``hetero``, ``outage``, ``shadowing`` — anything built on
``realize_network``): the legacy ``blockfade``/``frozen`` draws don't record
user positions, so there is nothing to attach to (a ``ValueError`` says so).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Union

import numpy as np

from repro_torch.config import FedsLLMConfig
from repro_torch.core import delay_model as dm
from repro_torch.core import fedsllm
from repro_torch.core.fedsllm import RoundTiming
from repro_torch.core.resource_alloc import Allocation
from repro_torch.des import queueing
from repro_torch.net import allocation as hier_alloc
from repro_torch.net import delay as hier_delay
from repro_torch.registry import Registry

topologies: Registry = Registry("topology")


class Topology:
    """Base class: the flat (star) graph; subclasses add tiers.

    All methods must be pure in their arguments — campaigns re-derive the
    attachment every round from that round's network, so determinism in
    ``(seed, round)`` is inherited from the scenario that drew the network.
    """

    name = "topology"
    #: number of intermediate nodes (edges / relays); 0 = flat
    num_edges = 0
    #: whether the in-trace aggregation is two-tier (per-edge then cloud)
    two_tier = False

    # -- identity ----------------------------------------------------------
    def params(self) -> dict:
        """Constructor parameters that change the graph (digest input)."""
        return {}

    def digest(self, fcfg: FedsLLMConfig, scenario, seed: int) -> str:
        """Checkpoint identity: graph params + constructor-time attachment.

        Two campaigns that share a scenario draw but hang clients off
        different graphs (edge count, backhaul capacity, or a different
        attachment realisation) are different campaigns — resume must be
        able to tell them apart.
        """
        h = hashlib.sha1(repr(sorted(self.params().items())).encode())
        if self.num_edges:
            net = scenario.initial_network(fcfg, seed)
            assign = self.attach(fcfg, net)
            h.update(np.ascontiguousarray(assign, np.int64).tobytes())
        return h.hexdigest()[:16]

    # -- attachment --------------------------------------------------------
    def edge_xy(self, fcfg: FedsLLMConfig) -> Optional[np.ndarray]:
        """(M, 2) deterministic edge positions; None for the flat graph."""
        return None

    def attach(self, fcfg: FedsLLMConfig,
               net: dm.Network) -> Optional[np.ndarray]:
        """(K,) edge index per client (minimum path loss); None when flat."""
        return None

    def localize(self, fcfg: FedsLLMConfig, net: dm.Network
                 ) -> tuple[dm.Network, Optional[np.ndarray]]:
        """Re-anchor the wireless hop on the attached edge.

        Returns ``(net', assign)``: for the flat graph this is the identity;
        hierarchical graphs move each client's path loss from the BS to its
        nearest edge (the shadowing realisation is preserved — only the
        deterministic distance term changes), so every downstream consumer
        (allocator, retiming, deadline masks) prices the client→edge link.
        """
        return net, None

    # -- allocation + timing ----------------------------------------------
    def allocate(self, fcfg: FedsLLMConfig, net: dm.Network,
                 assign: Optional[np.ndarray], allocate_fn, *,
                 strategy: str = "proposed", **kw) -> Allocation:
        """Solve (16)/(17) on this graph; flat = the legacy single-pool solve."""
        return allocate_fn(fcfg, net, **kw)

    def round_timing(self, fcfg: FedsLLMConfig, net: dm.Network,
                     alloc: Allocation, eta: float,
                     assign: Optional[np.ndarray]) -> RoundTiming:
        """End-to-end per-client round time (max over the client's path)."""
        return fedsllm.simulate_round_time(fcfg, net, alloc, eta)

    def backhaul_seconds(self, fcfg: FedsLLMConfig,
                         assign: Optional[np.ndarray],
                         eta: float) -> np.ndarray:
        """(K,) per-client backhaul hop time this round; zeros when flat
        (``assign=None`` — the star graph has no second hop)."""
        return np.zeros(0 if assign is None else len(assign))

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"{type(self).__name__}({self.name!r})"


@topologies.register("star")
class StarTopology(Topology):
    """The legacy flat FedsLLM graph — every client one wireless hop from
    both servers, one shared bandwidth pool.  Bit-identical to the
    pre-topology engine (every method is the identity / legacy call)."""

    name = "star"


class HierTopology(Topology):
    """Shared machinery for multi-hop graphs: edge placement, attachment,
    localization and the per-cell allocator; subclasses define what the
    backhaul hop carries.

    ``placement`` picks where the M edges stand: ``"ring"`` (the legacy
    deterministic circle at ``area_m/4``) or ``"kmeans"`` — facility
    location over the drawn user geometry (Lloyd's algorithm seeded at the
    ring, so it is a pure deterministic function of the scenario's
    large-scale draw; mobility scenarios re-place per round with the rest
    of localization).  ``backhaul_model`` prices the edge→cloud hop:
    ``"serial"`` (the legacy fixed-capacity pipe — every cell member waits
    the full cell transfer), ``"fifo"`` or ``"ps"`` — the SHARED metro
    backhaul as a queueing resource (``repro_torch.des.queueing``): cells contend,
    each transfer's arrival is its client's wireless completion, and the
    per-client hop is its own wait+service.  ``downlink_bps`` > 0 adds the
    per-round global-model broadcast cost (one multicast per cell,
    ``queueing.broadcast_seconds``); 0 keeps the paper's negligible-downlink
    convention.

    Under a queued backhaul the 'proposed' allocator closes the
    allocator↔queueing loop (``repro_torch.net.allocation.solve_wait_aware``):
    ``wait_aware=False`` opts a queued-backhaul graph back into the legacy
    wait-blind per-cell solves (serial graphs never run the loop either
    way), ``wait_iters`` caps the deterministic fixed-point iteration and
    ``wait_damping`` ∈ (0, 1] is its update step.
    """

    def __init__(self, num_edges: int = 2, backhaul_bps: float = 200e6,
                 placement: str = "ring", backhaul_model: str = "serial",
                 downlink_bps: float = 0.0, wait_aware: bool = True,
                 wait_iters: int = 8, wait_damping: float = 0.5):
        if num_edges < 1:
            raise ValueError(f"num_edges must be ≥ 1, got {num_edges}")
        if backhaul_bps <= 0:
            raise ValueError(f"backhaul_bps must be > 0, got {backhaul_bps}")
        if placement not in ("ring", "kmeans"):
            raise ValueError(f"unknown placement {placement!r}; "
                             f"known: ['kmeans', 'ring']")
        if backhaul_model not in ("serial", "fifo", "ps"):
            raise ValueError(f"unknown backhaul_model {backhaul_model!r}; "
                             f"known: ['fifo', 'ps', 'serial']")
        if wait_iters < 1:
            raise ValueError(f"wait_iters must be ≥ 1, got {wait_iters}")
        if not 0.0 < wait_damping <= 1.0:
            raise ValueError(f"wait_damping must be in (0, 1], "
                             f"got {wait_damping}")
        self.num_edges = int(num_edges)
        self.backhaul_bps = float(backhaul_bps)
        self.placement = placement
        self.backhaul_model = backhaul_model
        self.downlink_bps = float(downlink_bps)
        self.wait_aware = bool(wait_aware)
        self.wait_iters = int(wait_iters)
        self.wait_damping = float(wait_damping)

    def params(self) -> dict:
        return {"num_edges": self.num_edges, "backhaul_bps": self.backhaul_bps,
                "placement": self.placement,
                "backhaul_model": self.backhaul_model,
                "downlink_bps": self.downlink_bps,
                "wait_aware": self.wait_aware,
                "wait_iters": self.wait_iters,
                "wait_damping": self.wait_damping}

    def edge_xy(self, fcfg: FedsLLMConfig,
                net: Optional[dm.Network] = None) -> np.ndarray:
        """(M, 2) edge positions.

        ``ring``: evenly spaced on a circle of radius ``area_m/4`` — a
        deterministic function of (M, area) so no RNG stream is consumed
        (the scenario owns every random draw).  ``kmeans``: Lloyd's
        facility location over the round's user geometry, initialised AT
        the ring — still RNG-free, pure in the scenario's draw, and it
        re-places edges as geometry evolves (``drift``)."""
        ang = 2.0 * np.pi * np.arange(self.num_edges) / self.num_edges
        r = fcfg.area_m / 4.0
        ring = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
        if self.placement == "ring":
            return ring
        if net is None or net.xy is None:
            raise ValueError(
                f"placement 'kmeans' places edges over the user geometry; "
                f"topology {self.name!r} got no positions (use a "
                f"geometry-carrying scenario like geo-blockfade)")
        return _lloyd(net.xy, ring)

    def attach(self, fcfg: FedsLLMConfig, net: dm.Network) -> np.ndarray:
        if net.xy is None:
            raise ValueError(
                f"topology {self.name!r} needs a geometry-carrying scenario "
                f"(Network.xy is None — the legacy 'blockfade'/'frozen' "
                f"draws don't record positions); use geo-blockfade, drift, "
                f"hetero, outage or shadowing")
        # nearest edge == minimum distance path loss (monotone in distance)
        d = np.linalg.norm(
            net.xy[:, None, :] - self.edge_xy(fcfg, net)[None, :, :], axis=2)
        return np.argmin(d, axis=1)

    def localize(self, fcfg: FedsLLMConfig, net: dm.Network
                 ) -> tuple[dm.Network, np.ndarray]:
        assign = self.attach(fcfg, net)
        exy = self.edge_xy(fcfg, net)[assign]
        # the SAME path-loss law that produced net.pl_db, on the relative
        # client→edge positions — keep the round's shadowing realisation
        # and swap only the distance term: g' = g · 10^((pl_bs − pl_edge)/10)
        pl_edge = dm.path_loss_db(fcfg, net.xy - exy)
        ratio = dm.db_to_lin(net.pl_db - pl_edge)
        return dataclasses.replace(net, g_c=net.g_c * ratio,
                                   g_s=net.g_s * ratio,
                                   pl_db=pl_edge), assign

    def allocate(self, fcfg: FedsLLMConfig, net: dm.Network,
                 assign: Optional[np.ndarray], allocate_fn, *,
                 strategy: str = "proposed", **kw) -> Allocation:
        return hier_alloc.optimize_cells(fcfg, net, assign, self,
                                         allocate_fn, strategy=strategy, **kw)

    def round_timing(self, fcfg: FedsLLMConfig, net: dm.Network,
                     alloc: Allocation, eta: float,
                     assign: Optional[np.ndarray]) -> RoundTiming:
        wireless = fedsllm.simulate_round_time(fcfg, net, alloc, eta)
        return hier_delay.compose(
            wireless,
            self.backhaul_hop(fcfg, assign, eta,
                              np.asarray(wireless.total, float)),
            assign,
            self.downlink_hop(fcfg, assign))

    def backhaul_hop(self, fcfg: FedsLLMConfig, assign: np.ndarray,
                     eta: float, totals: np.ndarray) -> np.ndarray:
        """(K,) backhaul hop given per-client wireless completion times —
        THE composition point for the edge→cloud leg (``round_timing`` and
        the pipelined execution schedule both price through it, so the
        serial-vs-queued dispatch lives in exactly one place).
        """
        if self.backhaul_model == "serial":
            return self.backhaul_seconds(fcfg, assign, eta)
        return self._queued_backhaul(fcfg, assign, eta, np.asarray(totals, float))

    def downlink_hop(self, fcfg: FedsLLMConfig,
                     assign: np.ndarray) -> Optional[np.ndarray]:
        """(K,) per-round global-model broadcast cost, or None when
        disabled: one multicast per cell per round, cells broadcast in
        parallel, every member pays the same wait."""
        if self.downlink_bps <= 0:
            return None
        return np.full(len(assign), queueing.broadcast_seconds(
            fcfg.s_c_bits, self.downlink_bps))

    # -- per-edge traffic on the backhaul hop ------------------------------
    def _cell_bits(self, fcfg: FedsLLMConfig, assign: np.ndarray,
                   eta: float) -> np.ndarray:
        """(M,) bits each edge pushes over its backhaul per global round.

        Priced for the FULL attached population, matching the §III delay
        model's convention: every one of the K simulated clients trains each
        global round (the wireless bandwidth split is likewise solved for
        all K), and campaign cohorts subsample *that* priced round rather
        than re-pricing the network per cohort.
        """
        raise NotImplementedError

    def backhaul_seconds(self, fcfg: FedsLLMConfig,
                         assign: np.ndarray, eta: float) -> np.ndarray:
        """The legacy serial-pipe hop: (K,) per-client backhaul seconds —
        all of a cell's traffic shares its pipe, every member waits the
        full cell transfer (bit-identical to the pre-queueing engine; the
        default ``backhaul_model="serial"``)."""
        bits = self._cell_bits(fcfg, assign, eta)
        return (bits / self.backhaul_bps)[assign]

    def _backhaul_jobs(self, fcfg: FedsLLMConfig, assign: np.ndarray,
                       eta: float, totals: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The queue's job list: ``(arrivals, bits, job_of_client)``.

        Default: one job per client — its fed-traffic transfer arrives at
        the metro queue when its wireless round completes.  ``edge-agg``
        overrides with one job per edge (the pre-aggregated delta leaves
        once the whole cell has reported)."""
        K = len(assign)
        counts = np.bincount(assign, minlength=self.num_edges)
        per_client = (self._cell_bits(fcfg, assign, eta)
                      / np.maximum(counts, 1))[assign]
        return totals, per_client, np.arange(K)

    def _queued_backhaul(self, fcfg: FedsLLMConfig, assign: np.ndarray,
                         eta: float, totals: np.ndarray) -> np.ndarray:
        """(K,) backhaul hop under the SHARED metro queue (``fifo``/``ps``):
        cells contend for one ``backhaul_bps`` resource, and each client's
        hop is its own job's wait + service (``repro_torch.des.queueing``)."""
        arrivals, bits, job_of = self._backhaul_jobs(fcfg, assign, eta,
                                                     totals)
        if self.backhaul_model == "fifo":
            completion, _ = queueing.fifo(
                arrivals, queueing.service_seconds(bits, self.backhaul_bps))
        else:  # "ps"
            completion = queueing.processor_sharing(
                arrivals, np.asarray(bits, float), rate=self.backhaul_bps)
        # an outage'd client (wireless total +inf) never reaches the queue:
        # its hop is 0 so the composed path stays +inf instead of inf−inf
        hop = np.zeros_like(totals)
        finite = np.isfinite(totals)
        hop[finite] = completion[job_of][finite] - totals[finite]
        return hop


@topologies.register("edge-cloud")
class EdgeCloudTopology(HierTopology):
    """K clients → M edges → 1 cloud (SplitLLM-style).

    The edge hosts the server subnetwork: the per-iteration smashed
    activations (``s`` bits) terminate at the edge.  The cloud hosts the
    federated aggregator: each client's per-round LoRA delta (``s_c`` bits)
    transits the edge's backhaul, serialised with its cellmates'."""

    name = "edge-cloud"

    def _cell_bits(self, fcfg, assign, eta):
        counts = np.bincount(assign, minlength=self.num_edges)
        return counts * fcfg.s_c_bits


@topologies.register("edge-agg")
class EdgeAggTopology(HierTopology):
    """``edge-cloud`` plus edge-side pre-aggregation (two-tier fedavg).

    The edge averages its clients' LoRA deltas before the backhaul hop, so
    the backhaul carries ONE ``s_c`` payload per edge regardless of cell
    size, and the in-trace aggregation becomes per-edge → cross-edge
    (``federated.hier_aggregate``; the cohort's one-hot assignment matrix is
    a value-only round-function argument, like the straggler mask)."""

    name = "edge-agg"
    two_tier = True

    def _cell_bits(self, fcfg, assign, eta):
        return np.full(self.num_edges, fcfg.s_c_bits)

    def _backhaul_jobs(self, fcfg, assign, eta, totals):
        # one pre-aggregated delta per NON-EMPTY edge; it leaves for the
        # cloud once the cell's slowest DEADLINE-SURVIVING member has
        # reported, and every member of the cell rides its edge's job.  An
        # outage'd member (+inf wireless total) never reports and is exactly
        # the client the deadline mask drops — the edge aggregates without
        # it, so it must not hold every finite cellmate's hop at +inf.  The
        # arrival is +inf only when the WHOLE cell is outage'd.
        edges = np.unique(assign)
        arrivals = np.array([_finite_max(totals[assign == m]) for m in edges])
        job_of = np.searchsorted(edges, assign)
        return arrivals, np.full(len(edges), fcfg.s_c_bits), job_of


@topologies.register("relay")
class RelayTopology(HierTopology):
    """Clients behind relay nodes sharing one uplink pipe each.

    The relay is a pure forwarder: everything a client sends — the
    per-round fed delta AND every local iteration's smashed activations —
    transits the relay's uplink, serialised with its cellmates'.  The
    backhaul load therefore scales with Lemma 2's V(η) local-iteration
    count, which couples the relay hop into the η sweep."""

    name = "relay"

    def __init__(self, num_edges: int = 2, backhaul_bps: float = 50e6, **kw):
        super().__init__(num_edges=num_edges, backhaul_bps=backhaul_bps, **kw)

    def _cell_bits(self, fcfg, assign, eta):
        counts = np.bincount(assign, minlength=self.num_edges)
        V = dm.local_iters(fcfg, eta)
        return counts * (fcfg.s_c_bits + V * fcfg.s_bits)


def _finite_max(x: np.ndarray) -> float:
    """max over the finite entries; +inf when none are finite."""
    x = np.asarray(x, float)
    x = x[np.isfinite(x)]
    return float(np.max(x)) if x.size else np.inf


def _lloyd(xy: np.ndarray, init_centroids: np.ndarray,
           iters: int = 32) -> np.ndarray:
    """Deterministic Lloyd's k-means over user positions (facility location).

    Initialised at the caller's centroids (the ring), no RNG: the result is
    a pure function of the geometry, so campaigns stay reproducible and the
    checkpoint digest covers the placement through the attachment it
    induces.  Empty clusters keep their previous centroid (the ring point —
    it simply attracts nobody)."""
    cent = np.asarray(init_centroids, float).copy()
    for _ in range(iters):
        d = np.linalg.norm(xy[:, None, :] - cent[None, :, :], axis=2)
        lab = np.argmin(d, axis=1)
        new = cent.copy()
        for m in range(len(cent)):
            members = xy[lab == m]
            if len(members):
                new[m] = members.mean(axis=0)
        if np.allclose(new, cent, rtol=0, atol=1e-9):
            break
        cent = new
    return cent


def get_topology(spec: Union[str, Topology]) -> Topology:
    """Resolve a topology name or pass an instance through.

    ``get_topology("edge-cloud")`` → the registered default instance;
    ``get_topology(EdgeCloudTopology(num_edges=4))`` → the object itself.
    Unknown names raise ``KeyError`` listing the registered names.
    """
    if isinstance(spec, Topology):
        return spec
    if isinstance(spec, type) and issubclass(spec, Topology):
        return spec()
    cls = topologies.get(spec)
    return cls()
