"""First-class, composable channel-dynamics scenarios (port of
``repro/sim/scenario.py``: the same numpy draws, so the same networks and
digests).

How the §IV wireless network evolves across a campaign used to be an
implicit side effect of ``dm.sample_network(seed)``: every resampled round
teleported users to fresh positions, because the legacy draw conflates
*large-scale* state (geometry → path loss, shadow environment, client
heterogeneity C_k/D_k/f_max — physically fixed for minutes-to-hours) with
*small-scale* fading (coherence ≪ one round of LLM training).  This module
makes that evolution a first-class object: a :class:`Scenario` splits the
two timescales and is pluggable by name through a registry, mirroring the
aggregator and allocator registries of ``repro_torch.api``:

  ``frozen``         one realisation for the whole campaign (no dynamics)
  ``blockfade``      the legacy semantics, bit-frozen: a full fresh draw —
                     positions included — every round (the default)
  ``geo-blockfade``  fixed geometry + per-round shadow-fading redraws
  ``drift``          random-walk user mobility: positions move a bounded
                     step per round, path loss follows, fading redraws
  ``hetero``         device-class tiers: clients split into CPU/tx-power
                     classes over fixed geometry + per-round fading
  ``outage``         bursty deep fades: per-user extra loss that switches
                     on/off in multi-round bursts over geo-blockfade
  ``shadowing``      Gauss-Markov temporally-correlated shadowing: AR(1)
                     in dB across rounds (lag-1 autocorrelation ρ) with
                     the paper's N(0, σ²) per-round marginal preserved

Every scenario is a *pure function* of ``(fcfg, seed, round)`` — no hidden
state between calls — so campaigns stay bit-reproducible and checkpoint
resume replays exactly the rounds an uninterrupted run would have produced.

    sc = get_scenario("geo-blockfade")
    net0 = sc.initial_network(fcfg, seed)        # what the allocator solves on
    net_r = sc.round_network(fcfg, seed, r)      # round r's realisation

Unknown names raise ``KeyError`` listing the knowns, like every other
registry.  Custom dynamics: subclass :class:`Scenario` and pass the instance
wherever a scenario is taken (or register it by name).
"""

from __future__ import annotations

import dataclasses
import hashlib
from functools import lru_cache
from typing import Union

import numpy as np

from repro_torch.config import FedsLLMConfig
from repro_torch.core import delay_model as dm
from repro_torch.registry import Registry
from repro_torch.sim import events

# Stream tags decorrelating the scenario's auxiliary draws (mobility steps,
# tier assignment, outage bursts, shadowing innovations) from the fading
# stream of the same seed.
DRIFT_STREAM_TAG = 0xD21F7
HETERO_STREAM_TAG = 0x4E7E20
OUTAGE_STREAM_TAG = 0x0074A6E
SHADOW_STREAM_TAG = 0x5AD011

scenarios: Registry = Registry("scenario")


@lru_cache(maxsize=64)
def _base_large_scale(fcfg: FedsLLMConfig, seed: int) -> dm.LargeScaleState:
    """Cached once-per-campaign draw (FedsLLMConfig is frozen ⇒ hashable)."""
    return dm.sample_large_scale(fcfg, seed)


class Scenario:
    """Base class: large-scale state drawn once, fading redrawn per round.

    Subclasses override :meth:`round_large_scale` to evolve the persistent
    state (mobility, tiers) and/or :meth:`round_network` for fully custom
    dynamics.  All methods must be pure in their arguments — determinism in
    ``(seed, round)`` is part of the registry contract.
    """

    name = "scenario"

    # -- large-scale (once per campaign, optionally evolved) ---------------
    def large_scale(self, fcfg: FedsLLMConfig, seed: int) -> dm.LargeScaleState:
        """The campaign's persistent state (round 0 geometry for mobility)."""
        return _base_large_scale(fcfg, seed)

    def round_large_scale(self, fcfg: FedsLLMConfig, campaign_seed: int,
                          round_idx: int) -> dm.LargeScaleState:
        """Large-scale state in effect at ``round_idx`` (default: static)."""
        return self.large_scale(fcfg, campaign_seed)

    # -- realisations ------------------------------------------------------
    def initial_network(self, fcfg: FedsLLMConfig, seed: int) -> dm.Network:
        """The constructor-time realisation the allocator is first solved on."""
        return dm.realize_network(fcfg, self.large_scale(fcfg, seed), seed=seed)

    def round_network(self, fcfg: FedsLLMConfig, campaign_seed: int,
                      round_idx: int) -> dm.Network:
        """The realisation round ``round_idx`` trains under."""
        return dm.realize_network(
            fcfg, self.round_large_scale(fcfg, campaign_seed, round_idx),
            seed=events.round_seed(campaign_seed, round_idx))

    # -- identity ----------------------------------------------------------
    def params(self) -> dict:
        """Constructor parameters that change the dynamics (digest input).

        Subclasses with knobs (mobility step, outage prob, tiers) must
        return them here: two campaigns that share a large-scale draw but
        evolve it differently are different campaigns, and checkpoint
        resume has to be able to tell them apart.
        """
        return {}

    def digest(self, fcfg: FedsLLMConfig, seed: int) -> str:
        """Checkpoint identity: large-scale realisation + dynamics params."""
        h = hashlib.sha1(self.large_scale(fcfg, seed).digest.encode())
        h.update(repr(sorted(self.params().items())).encode())
        return h.hexdigest()[:16]

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"{type(self).__name__}({self.name!r})"


@scenarios.register("frozen")
class FrozenScenario(Scenario):
    """One §IV realisation for the whole campaign — no channel dynamics.

    ``resample_channel=True`` under this scenario degenerates to the
    frozen-channel run bit-exactly (the per-round "redraw" returns the same
    realisation, so retiming re-derives the same uplink times).
    """

    name = "frozen"

    def initial_network(self, fcfg, seed):
        # the legacy draw, for bit-compat with pre-scenario constructors
        return dm.sample_network(fcfg, seed=seed)

    def round_network(self, fcfg, campaign_seed, round_idx):
        return self.initial_network(fcfg, campaign_seed)


@scenarios.register("blockfade")
class BlockFadeScenario(Scenario):
    """The legacy per-round semantics, kept bit-identical (the default).

    Every round is a full fresh ``sample_network`` draw — geometry and
    heterogeneity included — keyed by ``(campaign_seed, round)`` exactly as
    the pre-scenario campaign engine did, so existing campaign goldens and
    determinism tests reproduce bit-for-bit.
    """

    name = "blockfade"

    def initial_network(self, fcfg, seed):
        return dm.sample_network(fcfg, seed=seed)

    def round_network(self, fcfg, campaign_seed, round_idx):
        return events.round_network(fcfg, campaign_seed, round_idx)


@scenarios.register("geo-blockfade")
class GeoBlockFadeScenario(Scenario):
    """Fixed geometry + per-round shadow-fading redraws (ROADMAP item #1).

    User positions, path loss and client heterogeneity are drawn once per
    campaign; only the small-scale fading is redrawn each round.  This is
    the physically-honest block-fading model: fading decorrelates between
    rounds, users do not teleport.
    """

    name = "geo-blockfade"


@scenarios.register("drift")
class DriftScenario(Scenario):
    """Random-walk mobility: users take one bounded step per round.

    Positions at round r are the round-0 geometry plus r i.i.d. Gaussian
    steps of scale ``step_m`` (clipped to the cell), recomputed from scratch
    from the seed each call so round r's network is a pure function of
    ``(seed, r)`` — checkpoint resume replays the walk exactly.
    """

    name = "drift"

    def __init__(self, step_m: float = 20.0):
        self.step_m = float(step_m)

    def params(self):
        return {"step_m": self.step_m}

    def round_large_scale(self, fcfg, campaign_seed, round_idx):
        ls = self.large_scale(fcfg, campaign_seed)
        if round_idx <= 0:
            return ls
        rng = np.random.default_rng([campaign_seed, DRIFT_STREAM_TAG])
        steps = rng.normal(size=(round_idx, ls.K, 2)) * self.step_m
        half = fcfg.area_m / 2.0
        xy = np.clip(ls.xy + steps.sum(axis=0), -half, half)
        return dataclasses.replace(ls, xy=xy, pl_db=dm.path_loss_db(fcfg, xy))


@scenarios.register("hetero")
class HeteroScenario(Scenario):
    """Device/tx-power class tiers over fixed geometry + per-round fading.

    Each client is assigned (deterministically from the seed) to one of
    ``len(f_tiers_hz)`` device classes; its CPU speed and uplink power
    budget come from its class instead of the paper's homogeneous 2 GHz /
    10 dBm.  The delay-minimisation allocator then has real heterogeneity
    to trade bandwidth against.
    """

    name = "hetero"

    def __init__(self, f_tiers_hz=(0.5e9, 1e9, 2e9),
                 p_tiers_dbm=(4.0, 10.0, 16.0)):
        if len(f_tiers_hz) != len(p_tiers_dbm):
            raise ValueError("f_tiers_hz and p_tiers_dbm must align")
        self.f_tiers_hz = tuple(float(f) for f in f_tiers_hz)
        self.p_tiers_dbm = tuple(float(p) for p in p_tiers_dbm)

    def params(self):
        return {"f_tiers_hz": self.f_tiers_hz, "p_tiers_dbm": self.p_tiers_dbm}

    def large_scale(self, fcfg, seed):
        ls = _base_large_scale(fcfg, seed)
        rng = np.random.default_rng([seed, HETERO_STREAM_TAG])
        tier = rng.integers(0, len(self.f_tiers_hz), size=ls.K)
        p_w = np.asarray([dm.dbm_to_watt(p) for p in self.p_tiers_dbm])[tier]
        return dataclasses.replace(
            ls, f_max=np.asarray(self.f_tiers_hz)[tier],
            p_c_max=p_w, p_s_max=p_w)


@scenarios.register("outage")
class OutageScenario(Scenario):
    """Bursty deep fades: per-user extra loss switching in round blocks.

    In each burst window of ``burst_rounds`` consecutive rounds, every user
    is independently in outage with probability ``prob``; an outaged user's
    links lose an extra ``depth_db`` on top of the round's fading draw for
    the whole window (deterministic in ``(seed, round)``: window membership
    is keyed by the window index, not chained round-to-round).
    """

    name = "outage"

    def __init__(self, prob: float = 0.15, depth_db: float = 25.0,
                 burst_rounds: int = 3):
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"outage prob must be in [0, 1], got {prob}")
        if burst_rounds < 1:
            raise ValueError(f"burst_rounds must be ≥ 1, got {burst_rounds}")
        self.prob = float(prob)
        self.depth_db = float(depth_db)
        self.burst_rounds = int(burst_rounds)

    def params(self):
        return {"prob": self.prob, "depth_db": self.depth_db,
                "burst_rounds": self.burst_rounds}

    def extra_loss_db(self, fcfg, campaign_seed, round_idx) -> np.ndarray:
        window = round_idx // self.burst_rounds
        rng = np.random.default_rng([campaign_seed, OUTAGE_STREAM_TAG, window])
        hit = rng.uniform(size=fcfg.num_clients) < self.prob
        return np.where(hit, self.depth_db, 0.0)

    def round_network(self, fcfg, campaign_seed, round_idx):
        return dm.realize_network(
            fcfg, self.round_large_scale(fcfg, campaign_seed, round_idx),
            seed=events.round_seed(campaign_seed, round_idx),
            extra_loss_db=self.extra_loss_db(fcfg, campaign_seed, round_idx))


@scenarios.register("shadowing")
class ShadowingScenario(Scenario):
    """Gauss-Markov temporally-correlated shadowing (AR(1) in dB).

    The i.i.d. per-round shadow draws of ``geo-blockfade`` ignore that a
    user standing behind the same building fades the same way for many
    rounds.  Here each link's log-normal shadowing follows the classic
    Gudmundson/Gauss-Markov process across rounds r,

        S_0 = σ·ε_0,   S_r = ρ·S_{r-1} + σ·sqrt(1-ρ²)·ε_r,   ε ~ N(0, 1)

    which keeps the stationary per-round marginal N(0, σ²) of the paper's
    §IV model (σ = ``shadow_std_db``) while adding lag-1 autocorrelation ρ.
    The whole innovation stream is keyed by the campaign seed alone and the
    recursion is re-run from round 0 on every call, so round r's field is a
    pure function of ``(seed, r)`` — checkpoint resume replays the process
    exactly (same idiom as the ``drift`` walk).
    """

    name = "shadowing"

    def __init__(self, rho: float = 0.8):
        if not 0.0 <= rho < 1.0:
            raise ValueError(f"shadowing rho must be in [0, 1), got {rho}")
        self.rho = float(rho)

    def params(self):
        return {"rho": self.rho}

    def shadow_db(self, fcfg: FedsLLMConfig, campaign_seed: int,
                  round_idx: int) -> np.ndarray:
        """(2, K) correlated shadow field at ``round_idx`` (fed, main)."""
        rng = np.random.default_rng([campaign_seed, SHADOW_STREAM_TAG])
        eps = rng.normal(size=(round_idx + 1, 2, fcfg.num_clients))
        # closed-form AR(1): S_r = σ(ρ^r ε_0 + sqrt(1-ρ²) Σ_{i≥1} ρ^{r-i} ε_i)
        coef = self.rho ** np.arange(round_idx, -1, -1.0)
        coef[1:] *= np.sqrt(1.0 - self.rho**2)
        return fcfg.shadow_std_db * np.tensordot(coef, eps, axes=(0, 0))

    def round_network(self, fcfg, campaign_seed, round_idx):
        return dm.realize_network(
            fcfg, self.round_large_scale(fcfg, campaign_seed, round_idx),
            seed=events.round_seed(campaign_seed, round_idx),
            shadow_db=self.shadow_db(fcfg, campaign_seed, round_idx))


# the registry stores classes (decorator-friendly); lookups hand out default
# instances, parameterised variants are constructed directly
def get_scenario(spec: Union[str, Scenario]) -> Scenario:
    """Resolve a scenario name or pass an instance through.

    ``get_scenario("geo-blockfade")`` → the registered default instance;
    ``get_scenario(DriftScenario(step_m=50))`` → the object itself.
    Unknown names raise ``KeyError`` listing the registered names.
    """
    if isinstance(spec, Scenario):
        return spec
    if isinstance(spec, type) and issubclass(spec, Scenario):
        return spec()
    cls = scenarios.get(spec)
    return cls()
