"""Split-learning microbatch pipelining: the latency model (port of the numpy
half of ``repro/parallel/pipeline.py``).

Algorithm 2 is strictly sequential per local iteration:
    client fwd  →  uplink A_k  →  server fwd/bwd  →  downlink dA_k  →
    client bwd
so the client idles during server compute + transfers and vice versa.
Splitting the local batch into M microbatches pipelines the stages
(GPipe-style, applied across the *wireless* split): while the server
processes microbatch j, the client already runs forward on j+1.

``pipeline_round_time`` is the latency model: the sequential cost
M·(t_cl + t_up + t_srv + t_down + t_cl_bwd) collapses to
(sum of stages)/M + (M−1)/M·max(stage), the paper's delay model extended
with the overlap factor; ``split_stage_times`` derives the stages from the
delay model and an allocation. The ``pipelined`` execution schedule
(``des/schedules.py``) prices its rounds with them.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core import delay_model as dm


def pipeline_round_time(stage_seconds: dict[str, np.ndarray | float],
                        num_microbatches: int) -> dict[str, Any]:
    """Latency of one local iteration with M microbatches.

    stage_seconds: {client_fwd, uplink, server, downlink, client_bwd} —
    full-batch stage times (scalars or per-client arrays).  Each microbatch
    costs stage/M; the pipeline completes in  sum(stages)/M + (M−1)/M ·
    max(stage)  vs the sequential  sum(stages)."""
    stages = {k: np.asarray(v, dtype=float) for k, v in stage_seconds.items()}
    total = sum(stages.values())
    if num_microbatches <= 1:
        return {"sequential_s": total, "pipelined_s": total, "speedup": np.ones_like(total)}
    M = num_microbatches
    bottleneck = np.maximum.reduce([v for v in stages.values()])
    pipelined = total / M + (M - 1) / M * bottleneck
    return {
        "sequential_s": total,
        "pipelined_s": pipelined,
        "speedup": total / pipelined,
        "bottleneck_s": bottleneck,
    }


def split_stage_times(cfg_feds, net, eta: float, A: float, alloc,
                      model_params=None,
                      downlink_frac: float = 0.1) -> dict[str, np.ndarray]:
    """Derive per-stage times from the paper's delay model + an allocation:
    client/server compute from eq. (10) split by A, uplink from t_s, and a
    ``downlink_frac``-scaled downlink estimate (the paper treats the
    downlink as negligible; the default 0.1 keeps the standalone pipeline
    model conservative, while the ``pipelined`` execution schedule passes 0
    so its stage sum matches eq. (15)'s round total exactly)."""
    V = dm.local_iters(cfg_feds, eta)
    w = float(model_params if model_params is not None else cfg_feds.sample_dim)
    E_k = dm.lemma_v(cfg_feds) * w * net.C_k * net.D_k
    t_cl = E_k * np.log2(1.0 / eta) * (A / net.f_max) / V
    t_srv = E_k * np.log2(1.0 / eta) * ((1.0 - A) / net.f_server) / V
    return {
        "client_fwd": 0.5 * t_cl,
        "uplink": np.asarray(alloc.t_s, float),
        "server": t_srv,
        "downlink": downlink_frac * np.asarray(alloc.t_s, float),  # high-power BS
        "client_bwd": 0.5 * t_cl,
    }
