"""Split-learning microbatch pipelining (port of ``repro/parallel/pipeline.py``).

Algorithm 2 is strictly sequential per local iteration:
    client fwd  →  uplink A_k  →  server fwd/bwd  →  downlink dA_k  →
    client bwd
so the client idles during server compute + transfers and vice versa.
Splitting the local batch into M microbatches pipelines the stages
(GPipe-style, applied across the *wireless* split): while the server
processes microbatch j, the client already runs forward on j+1.

``pipelined_split_grads`` is the numerically exact microbatched split
value+grad: the mean over M microbatches equals the full-batch split step.
On one card the microbatches run one after the other (a Python loop over
``core/split.split_value_and_grad``); the overlap is what the latency model
prices.

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

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import delay_model as dm
from repro_torch.core import split as split_lib
from repro_torch.tree import tree_leaves, tree_map


def pipelined_split_grads(params, lora_c, lora_s, batch, cfg: ModelConfig,
                          cut: int, num_microbatches: int):
    """Microbatched split step: (mean loss, mean dlora_c, mean dlora_s) over M
    microbatches, the gradients accumulated in fp32 and scaled by 1/M (fp32
    whatever the adapters' dtype, as the reference's). Equals the full-batch
    split step when B % M == 0."""
    B = tree_leaves(batch)[0].shape[0]
    M = num_microbatches
    assert B % M == 0, (B, M)
    mb = B // M
    f32 = lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    loss_acc = torch.zeros((), dtype=torch.float32, device=tree_leaves(batch)[0].device)
    dc_acc, ds_acc = tree_map(f32, lora_c), tree_map(f32, lora_s)
    for i in range(M):
        sub = tree_map(lambda x: x[i * mb:(i + 1) * mb], batch)
        loss, dc, ds, _ = split_lib.split_value_and_grad(params, lora_c, lora_s, sub, cfg, cut)
        loss_acc = loss_acc + loss
        dc_acc = tree_map(torch.add, dc_acc, dc)
        ds_acc = tree_map(torch.add, ds_acc, ds)
    inv = 1.0 / M
    scale = lambda t: tree_map(lambda x: x * inv, t)
    return loss_acc * inv, scale(dc_acc), scale(ds_acc)


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
