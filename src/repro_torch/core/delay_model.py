"""FedsLLM training-delay model (paper §III, eqs. 8–15) + wireless channel.

The port's copy of ``repro/core/delay_model.py``: the same numpy code, so
the same (config, seed) gives bit-identical results in both packages.

Implements, exactly as in the paper:
  * Lemma 1:  I0 = a/(1-η),  a = (2L²/γ²ξ)·ln(1/ε0)      (global rounds)
  * Lemma 2:  i ≥ v·log2(1/η),  v = 2/((2-Lδ)δγ)          (local iterations)
  * eq. (10): τ_k = E_k·log2(1/η)·(A/f_k + (1-A)/f_s),  E_k = v|w|C_k D_k
  * eq. (11): r = b·log2(1 + g·p/(N·b))                    (FDMA rate)
  * eq. (15): T_k = I0·(τ_k + t_c,k + v·log2(1/η)·t_s,k)

Channel realisation follows §IV: K users uniform in a 500 m square around
the BS, path loss 128.1 + 37.6·log10(d_km) dB, 8 dB log-normal shadowing,
N0 = −174 dBm/Hz, C_k ~ U[1,3]·1e4 cycles, p_max = 10 dBm, f_max = 2 GHz.
All math is numpy (host-side — this is the simulator that drives the
resource allocator, not device compute).
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.config import FedsLLMConfig


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** (dbm / 10.0) / 1000.0


def db_to_lin(db: float) -> float:
    return 10.0 ** (db / 10.0)


# ---------------------------------------------------------------------------
# Network realisation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Network:
    """One sampled wireless network + client heterogeneity realisation."""

    g_c: np.ndarray  # (K,) linear channel gains to fed server
    g_s: np.ndarray  # (K,) linear channel gains to main server
    C_k: np.ndarray  # (K,) cycles per (sample·param)
    D_k: np.ndarray  # (K,) local dataset sizes
    f_max: np.ndarray  # (K,) client CPU Hz
    p_c_max: np.ndarray  # (K,) W
    p_s_max: np.ndarray  # (K,) W
    N0: float  # W/Hz
    B_c: float  # Hz
    B_s: float  # Hz
    f_server: float  # Hz
    # provenance (filled by realize_network; None on the legacy all-at-once
    # draw) — lets scenario tests assert geometry invariants across rounds
    xy: Optional[np.ndarray] = None  # (K, 2) user positions, metres
    pl_db: Optional[np.ndarray] = None  # (K,) distance path loss, dB

    @property
    def K(self) -> int:
        return len(self.g_c)


@dataclass(frozen=True)
class LargeScaleState:
    """Everything about the network that outlives one fading block.

    Drawn once per campaign (``sample_large_scale``) and held fixed — or
    evolved by a mobility step — while the small-scale fading is redrawn
    every round (``realize_network``).  The legacy ``sample_network`` path
    conflates the two (it redraws positions with every call); scenarios that
    promise geometry invariance compose these two halves instead.
    """

    xy: np.ndarray  # (K, 2) user positions, metres (BS at origin)
    pl_db: np.ndarray  # (K,) distance path loss, dB
    C_k: np.ndarray  # (K,) cycles per (sample·param)
    D_k: np.ndarray  # (K,) local dataset sizes
    f_max: np.ndarray  # (K,) client CPU Hz
    p_c_max: np.ndarray  # (K,) W
    p_s_max: np.ndarray  # (K,) W
    N0: float  # W/Hz
    B_c: float  # Hz
    B_s: float  # Hz
    f_server: float  # Hz

    @property
    def K(self) -> int:
        return len(self.pl_db)

    @property
    def digest(self) -> str:
        """Content hash of the large-scale realisation (checkpoint identity:
        resuming a campaign under different geometry/heterogeneity is a
        different campaign and must be refused)."""
        h = hashlib.sha1()
        for a in (self.xy, self.pl_db, self.C_k, self.D_k, self.f_max,
                  self.p_c_max, self.p_s_max):
            h.update(np.ascontiguousarray(np.asarray(a, float)).tobytes())
        h.update(np.asarray([self.N0, self.B_c, self.B_s, self.f_server],
                            float).tobytes())
        return h.hexdigest()[:16]


def path_loss_db(cfg: FedsLLMConfig, xy: np.ndarray) -> np.ndarray:
    """Distance path loss 128.1 + 37.6·log10(d_km) for positions (K, 2), m."""
    d_km = np.maximum(np.linalg.norm(xy, axis=1), 1.0) / 1000.0  # ≥1 m
    return cfg.pathloss_const_db + cfg.pathloss_exp * np.log10(d_km)


def sample_large_scale(cfg: FedsLLMConfig, seed: int = 0,
                       p_max_dbm: float | None = None) -> LargeScaleState:
    """Draw the once-per-campaign state: geometry + client heterogeneity.

    Same distributions as ``sample_network`` (§IV), but no channel gains —
    those are small-scale and belong to ``realize_network``.
    """
    rng = np.random.default_rng(seed)
    K = cfg.num_clients
    half = cfg.area_m / 2.0
    xy = rng.uniform(-half, half, size=(K, 2))
    p = dbm_to_watt(cfg.p_max_dbm if p_max_dbm is None else p_max_dbm)
    return LargeScaleState(
        xy=xy,
        pl_db=path_loss_db(cfg, xy),
        C_k=rng.uniform(cfg.cycles_per_param_low, cfg.cycles_per_param_high, size=K),
        D_k=np.full(K, cfg.num_samples // K, dtype=float),
        f_max=np.full(K, cfg.f_max_hz),
        p_c_max=np.full(K, p),
        p_s_max=np.full(K, p),
        N0=dbm_to_watt(cfg.noise_psd_dbm_hz),
        B_c=cfg.bandwidth_total_hz,
        B_s=cfg.bandwidth_total_hz,
        f_server=cfg.f_server_hz,
    )


def realize_network(cfg: FedsLLMConfig, ls: LargeScaleState, seed: int,
                    extra_loss_db: Optional[np.ndarray] = None,
                    shadow_db: Optional[np.ndarray] = None) -> Network:
    """One small-scale (per-round) realisation over fixed large-scale state.

    Redraws only the log-normal shadowing on both links, keyed by ``seed``;
    geometry, path loss and client heterogeneity come from ``ls`` unchanged.
    ``extra_loss_db`` (K,) adds a deterministic per-user deep-fade penalty on
    top (the ``outage`` scenario's burst loss) — applied to both links.
    ``shadow_db`` (2, K) overrides the i.i.d. shadowing draw with caller-
    provided per-link fields (row 0 → fed link, row 1 → main link) — the
    ``shadowing`` scenario's temporally-correlated AR(1) process; the RNG is
    then not consumed, so the existing i.i.d. draw order stays bit-frozen.
    """
    rng = np.random.default_rng(seed)
    K = ls.K
    extra = 0.0 if extra_loss_db is None else np.asarray(extra_loss_db, float)

    def gains(link: int):
        shadow = (rng.normal(0.0, cfg.shadow_std_db, size=K)
                  if shadow_db is None else np.asarray(shadow_db[link], float))
        return db_to_lin(-(ls.pl_db + shadow + extra))

    # copies, not views: callers mutate Network arrays in place (e.g. D_k
    # reweighting) and ``ls`` may be cached/shared across rounds
    return Network(
        g_c=gains(0),
        g_s=gains(1),
        C_k=ls.C_k.copy(),
        D_k=ls.D_k.copy(),
        f_max=ls.f_max.copy(),
        p_c_max=ls.p_c_max.copy(),
        p_s_max=ls.p_s_max.copy(),
        N0=ls.N0,
        B_c=ls.B_c,
        B_s=ls.B_s,
        f_server=ls.f_server,
        xy=ls.xy.copy(),
        pl_db=ls.pl_db.copy(),
    )


def sample_network(cfg: FedsLLMConfig, seed: int = 0, p_max_dbm: float | None = None) -> Network:
    """Legacy all-at-once draw: geometry + heterogeneity + gains in one shot.

    BIT-FROZEN: the ``frozen``/``blockfade`` scenarios and every pre-scenario
    campaign are keyed to this exact RNG consumption order — do not reorder
    the draws.  New scenario families compose ``sample_large_scale`` +
    ``realize_network`` instead, which separate what persists across rounds
    from what fades.
    """
    rng = np.random.default_rng(seed)
    K = cfg.num_clients
    half = cfg.area_m / 2.0
    xy = rng.uniform(-half, half, size=(K, 2))
    d_km = np.maximum(np.linalg.norm(xy, axis=1), 1.0) / 1000.0  # ≥1 m

    def gains():
        pl_db = cfg.pathloss_const_db + cfg.pathloss_exp * np.log10(d_km)
        shadow = rng.normal(0.0, cfg.shadow_std_db, size=K)
        return db_to_lin(-(pl_db + shadow))

    p = dbm_to_watt(cfg.p_max_dbm if p_max_dbm is None else p_max_dbm)
    # even sample split (paper: equal selection probability)
    D = np.full(K, cfg.num_samples // K, dtype=float)
    return Network(
        g_c=gains(),
        g_s=gains(),
        C_k=rng.uniform(cfg.cycles_per_param_low, cfg.cycles_per_param_high, size=K),
        D_k=D,
        f_max=np.full(K, cfg.f_max_hz),
        p_c_max=np.full(K, p),
        p_s_max=np.full(K, p),
        N0=dbm_to_watt(cfg.noise_psd_dbm_hz),  # W/Hz
        B_c=cfg.bandwidth_total_hz,
        B_s=cfg.bandwidth_total_hz,
        f_server=cfg.f_server_hz,
    )


# ---------------------------------------------------------------------------
# Lemma constants
# ---------------------------------------------------------------------------


def lemma_a(cfg: FedsLLMConfig) -> float:
    """a = (2L²/γ²ξ)·ln(1/ε0)  (Lemma 1)."""
    return 2.0 * cfg.L_smooth**2 / (cfg.gamma_strong**2 * cfg.xi) * np.log(1.0 / cfg.epsilon0)


def lemma_v(cfg: FedsLLMConfig) -> float:
    """v = 2/((2-Lδ)δγ)  (Lemma 2); requires δ < 2/L."""
    assert cfg.delta < 2.0 / cfg.L_smooth
    return 2.0 / ((2.0 - cfg.L_smooth * cfg.delta) * cfg.delta * cfg.gamma_strong)


def global_rounds(cfg: FedsLLMConfig, eta: float) -> float:
    return lemma_a(cfg) / (1.0 - eta)


def local_iters(cfg: FedsLLMConfig, eta: float) -> float:
    return lemma_v(cfg) * np.log2(1.0 / eta)


# ---------------------------------------------------------------------------
# Delay terms
# ---------------------------------------------------------------------------


def compute_time(cfg: FedsLLMConfig, net: Network, eta: float, A: float,
                 model_params: int | None = None) -> np.ndarray:
    """eq. (10): per-client compute time per global round (K,)."""
    w = float(model_params if model_params is not None else cfg.sample_dim)
    E_k = lemma_v(cfg) * w * net.C_k * net.D_k
    return E_k * np.log2(1.0 / eta) * (A / net.f_max + (1.0 - A) / net.f_server)


def rate(b: np.ndarray, g: np.ndarray, p: np.ndarray, N0: float) -> np.ndarray:
    """eq. (11): FDMA uplink rate, bits/s.  Safe at b -> 0 (limit 0)."""
    b = np.asarray(b, float)
    out = np.zeros_like(b)
    pos = b > 0
    out[pos] = b[pos] * np.log2(1.0 + g[pos] * p[pos] / (N0 * b[pos]))
    return out


def rate_scalar(b: float, g: float, p: float, N0: float) -> float:
    if b <= 0:
        return 0.0
    return b * np.log2(1.0 + g * p / (N0 * b))


def bandwidth_for_rate(r_req: np.ndarray, g: np.ndarray, p: np.ndarray, N0: float) -> np.ndarray:
    """Invert eq. (11) in closed form via Lambert W.

    r = b·log2(1 + c/b), c = g·p/N0.  With t = c/b and q = r·ln2/c ∈ (0,1):
    ln(1+t) = q·t  ⇒  t = −W₋₁(−q·e^{−q})/q − 1,  b = c/t.
    rate(b) is increasing & concave with limit c/ln2; returns +inf where
    r_req exceeds that capacity (infeasible regardless of bandwidth)."""
    from scipy.special import lambertw

    r_req = np.asarray(r_req, float)
    c = g * p / N0  # received SNR-per-Hz numerator
    q = r_req * np.log(2.0) / np.maximum(c, 1e-300)
    out = np.full_like(r_req, np.inf)
    zero = r_req <= 0
    ok = (~zero) & (q < 1.0 - 1e-12)
    if np.any(ok):
        qq = q[ok]
        w = np.real(lambertw(-qq * np.exp(-qq), k=-1))
        t = -w / qq - 1.0
        out[ok] = c[ok] / np.maximum(t, 1e-300)
    out[zero] = 0.0
    return out


def round_latency(cfg: FedsLLMConfig, net: Network, eta: float, A: float,
                  t_c: np.ndarray, t_s: np.ndarray,
                  model_params: int | None = None) -> np.ndarray:
    """eq. (15): total training latency per client, T_k (K,)."""
    I0 = global_rounds(cfg, eta)
    V = local_iters(cfg, eta)
    tau = compute_time(cfg, net, eta, A, model_params)
    return I0 * (tau + t_c + V * t_s)


def energy(cfg: FedsLLMConfig, net: Network, eta: float, A: float,
           t_c: np.ndarray, t_s: np.ndarray, model_params: int | None = None) -> np.ndarray:
    """Per-client energy (κ·f²·cycles + p·t), for diagnostics/extensions."""
    w = float(model_params if model_params is not None else cfg.sample_dim)
    V = local_iters(cfg, eta)
    cycles = V * np.log2(1.0 / eta) * w * net.C_k * net.D_k * A
    e_cmp = cfg.kappa * net.f_max**2 * cycles
    e_tx = net.p_c_max * t_c + net.p_s_max * V * t_s
    return global_rounds(cfg, eta) * (e_cmp + e_tx)
