"""Per-round scenario events for multi-round campaigns (port of
``repro/sim/events.py``).

A training campaign is not one frozen channel draw: the §IV wireless network
changes between global rounds (block fading — coherence ≫ one round, ≪ the
campaign), cohorts are subsampled from the simulated user population, and
clients whose realised delay exceeds the round deadline become stragglers.
This module generates those per-round events deterministically from a
campaign seed + round index, so a campaign is a pure function of
``(RunConfig, seed)`` and resume/replay is bit-identical.

Everything here is host-side numpy (it drives the simulator, not the round
function): only the resulting survivor ``mask`` crosses into device compute,
through the round function's existing ``mask`` argument.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.config import FedsLLMConfig
from repro_torch.core import delay_model as dm
from repro_torch.core import federated
from repro_torch.core.resource_alloc import Allocation, quantize_eta

# Mixing stride between the campaign seed and the round index (same prime
# idiom as ``federated.client_sample`` — distinct streams per round without
# collisions across nearby campaign seeds).
ROUND_SEED_STRIDE = 1_000_003
# Tag added to the campaign seed for cohort sampling.  ``client_sample``
# mixes with the same prime as ``round_seed``, so an untagged seed would
# give cohort selection the byte-identical PRNG stream as that round's
# channel draw — correlating who trains with how the channel faded.
COHORT_STREAM_TAG = 0x5EED
# Offset on the channel stream: without it, round 0 of campaign_seed 0
# would reuse seed 0 — the exact ``sample_network`` draw the experiment
# constructor made — so the "fresh" round-0 fade would be byte-identical
# to the realisation the allocator was solved on.
CHANNEL_STREAM_TAG = 7919


def round_seed(campaign_seed: int, round_idx: int) -> int:
    """Deterministic per-round seed for channel re-sampling."""
    return campaign_seed * ROUND_SEED_STRIDE + round_idx + CHANNEL_STREAM_TAG


def round_network(fcfg: FedsLLMConfig, campaign_seed: int,
                  round_idx: int, scenario=None) -> dm.Network:
    """The §IV network realisation round ``round_idx`` trains under.

    With a ``scenario`` (see ``repro_torch.sim.scenario``) the draw delegates to
    ``scenario.round_network`` — the scenario decides what persists across
    rounds and what fades.  Without one, this is the legacy ``blockfade``
    semantics: a full fresh draw keyed by round (bit-frozen — the default
    scenario and every pre-scenario campaign depend on it).
    """
    if scenario is not None:
        return scenario.round_network(fcfg, campaign_seed, round_idx)
    return dm.sample_network(fcfg, seed=round_seed(campaign_seed, round_idx))


def localized_round_network(fcfg: FedsLLMConfig, campaign_seed: int,
                            round_idx: int, scenario=None, topology=None):
    """Round draw + topology localization: ``(net, assign)``.

    The scenario draws the round's §IV realisation (vs the BS at the
    origin); the topology then re-anchors each client's wireless hop on its
    attached edge — attachment is recomputed from THIS round's large-scale
    state, so mobility scenarios (``drift``) re-attach clients as they move.
    Without a topology (or under ``star``) this is the plain round draw.
    """
    net = round_network(fcfg, campaign_seed, round_idx, scenario=scenario)
    if topology is None:
        return net, None
    return topology.localize(fcfg, net)


def round_state(exp, campaign_seed: int, round_idx: int, *,
                base_alloc: Optional[Allocation] = None,
                resample: bool = True, reallocate: bool = False,
                realloc_search: str = "warm"):
    """The full per-round pricing of round ``round_idx``, without mutating
    the experiment: ``(net, assign, alloc, eta, timing)``.

    This is the campaign loop's step (a) factored into a *pure* function of
    ``(exp's constructor state, campaign_seed, round_idx)`` — the loop calls
    it to advance the experiment, and the asynchronous execution schedules
    (``repro_torch.des.schedules``) call it to price client run durations at
    arbitrary round indices without disturbing the loop's state.  With
    ``resample=False`` every round prices identically to the constructor
    realisation (the frozen-channel semantics).  ``base_alloc`` is the last
    *solved* allocation the stale-retiming path re-prices (defaults to the
    experiment's current one); under ``reallocate=True`` the allocator
    re-solves jointly and ``eta`` comes back quantized onto the
    ``fcfg.eta_bucket`` grid exactly as ``Experiment.set_eta`` would adopt
    it, so loop and schedule agree bit-for-bit on the round's timing.
    """
    fcfg = exp.fcfg
    if not resample:
        return exp.net, exp.assign, exp.alloc, exp.eta, exp.timing
    # the population model (9th axis) may replace the exact queue pricing
    # with its analytic mean-field model and restrict per-cell re-solves to
    # representative clients; ``exact`` (and any unbound population) leaves
    # every path below bit-identical
    pop = getattr(exp, "population", None)
    net, assign = localized_round_network(fcfg, campaign_seed, round_idx,
                                          scenario=exp.scenario,
                                          topology=exp.topology)
    if reallocate:
        kw = {"eta_search": realloc_search}
        if realloc_search == "warm":
            kw["eta0"] = exp._eta0
        alloc = exp.topology.allocate(fcfg, net, assign, exp._allocate,
                                      strategy=exp.allocator_name,
                                      population=pop, **kw)
        if not alloc.feasible or not np.isfinite(alloc.eta):
            # an infeasible Allocation carries eta=nan on purpose — adopting
            # a fabricated η would silently train on an unsolvable round
            raise ValueError(
                f"round {round_idx}: allocator {exp.allocator_name!r} found "
                f"no feasible allocation on this round's network (scenario "
                f"{exp.scenario.name!r}, topology {exp.topology.name!r}) — "
                f"refusing to adopt η from an infeasible solve")
        eta = quantize_eta(alloc.eta, fcfg.eta_bucket, fcfg.eta_train_max)
    else:
        alloc = retime_allocation(fcfg, net,
                                  exp.alloc if base_alloc is None else base_alloc)
        eta = exp.eta
    timing = exp.topology.round_timing(fcfg, net, alloc, eta, assign,
                                       population=pop)
    return net, assign, alloc, eta, timing


def _transmit_time(bits: float, rate: np.ndarray) -> np.ndarray:
    """bits/rate with rate→0 treated as an outage (+inf, a sure straggler)."""
    rate = np.asarray(rate, float)
    out = np.full_like(rate, np.inf)
    np.divide(bits, rate, out=out, where=rate > 0)
    return out


def retime_allocation(fcfg: FedsLLMConfig, net: dm.Network,
                      alloc: Allocation) -> Allocation:
    """Re-price a *stale* allocation under a fresh channel draw.

    The bandwidth split (b_c, b_s) and model split A stay fixed (the
    allocator is not re-run), but the uplink times are what the new gains
    actually deliver at those bandwidths: t = s / r(b, g_new).  This is the
    source of deadline stragglers when the channel moves against a client
    between allocator solves.
    """
    r_c = dm.rate(alloc.b_c, net.g_c, net.p_c_max, net.N0)
    r_s = dm.rate(alloc.b_s, net.g_s, net.p_s_max, net.N0)
    return dataclasses.replace(
        alloc,
        t_c=_transmit_time(fcfg.s_c_bits, r_c),
        t_s=_transmit_time(fcfg.s_bits, r_s),
    )


def cohort_ids(round_idx: int, num_clients: int, cohort: int,
               seed: int = 0) -> np.ndarray:
    """Elastic cohort: which of the K simulated users train this round.

    ``cohort == num_clients`` degenerates to the identity (every user, every
    round); smaller cohorts are sampled without replacement, keyed by round.
    """
    if cohort >= num_clients:
        return np.arange(num_clients)
    return federated.client_sample(round_idx, num_clients, cohort,
                                   seed=seed + COHORT_STREAM_TAG)


def straggler_mask(round_total: np.ndarray, ids: np.ndarray,
                   deadline: Optional[float]) -> Optional[np.ndarray]:
    """(C,) survivor mask for this round's cohort, or None when no deadline.

    ``round_total`` is the simulated per-user round time (``RoundTiming.total``,
    shape (K,)); survivors are cohort members finishing by the deadline.
    """
    if deadline is None:
        return None
    return federated.deadline_mask(np.asarray(round_total)[ids], deadline)


def round_wall_clock(round_total: np.ndarray, ids: np.ndarray,
                     deadline: Optional[float]) -> float:
    """Simulated seconds the server spends on this round.

    Without a deadline the server waits for the slowest cohort member; with
    one it proceeds at min(slowest finisher, deadline) — stragglers are cut
    off, they don't stretch the round.
    """
    slowest = float(np.max(np.asarray(round_total)[ids]))
    return slowest if deadline is None else min(slowest, float(deadline))
