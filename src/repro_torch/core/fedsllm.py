"""FedsLLM orchestration, paper Algorithms 1 + 2 (port of
``repro/core/fedsllm.py``).

One *global round* (index n):
  1. broadcast the global LoRA Δw = (Δw_c, Δw_s) to K clients,
  2. round-start gradients g_k0 = ∇F_k(Δw) per client and
     ḡ = aggregate(g_k0) (the FEDL surrogate of problem (4) needs ∇F(Δw)),
  3. I_loc local iterations on problem (4) by gradient descent (eq. 9):
     h ← h − δ·∇G_k(h),  ∇G_k(h) = ∇F_k(Δw+h) − ∇F_k(Δw) + ξ·∇F(Δw),
     each ∇F_k one split forward/backward (``split.split_value_and_grad``),
  4. fed server + main server: Δw ← Δw + α·aggregate(h_k) (masked for
     stragglers or dropped clients).

The reference vmaps over the clients and scans over the local steps; here
both are Python loops, and the per-client trees are stacked (K, ...) for the
aggregators. The round never reads a value back to the host: its metrics
are 0-d tensors.

Lemma 2 sets I_loc (v·log2(1/η)); Lemma 1 the number of global rounds
(a/(1−η)); ``simulate_round_time`` prices a round's simulated wall-clock
from an allocation of ``resource_alloc``. Still to come, each with a later
slice and raising ``NotImplementedError`` until then: the uplink codecs
(``compressor``) and DP on the uploads (``dp_clip``; ``core/privacy.py``
comes with the codecs).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.config import FedsLLMConfig, ModelConfig
from repro_torch.core import delay_model as dm
from repro_torch.core import federated, lora as lora_lib, split
from repro_torch.fl.local_algos import get_local_algo
from repro_torch.models import transformer as T
from repro_torch.tree import tree_index, tree_leaves, tree_map, tree_stack, weak


class FedsLLMState(NamedTuple):
    base: Any  # frozen w0
    lora_c: Any  # global client-side adapters Δw_c
    lora_s: Any  # global server-side adapters Δw_s
    round: torch.Tensor  # global iteration n (0-d int32)


def init_state(cfg: ModelConfig, cut: int, seed: int = 0, device="cuda") -> FedsLLMState:
    """Base weights drawn from ``seed``, adapters (B = 0) from ``seed + 1``,
    cut after group ``cut``; on ``device``."""
    base = T.init_params(cfg, seed=seed, device=device)
    lc, ls = lora_lib.split_client_server(
        lora_lib.init_lora(base, cfg, seed=seed + 1, device=device), cut)
    return FedsLLMState(base, lc, ls, torch.zeros((), dtype=torch.int32, device=device))


def local_iteration_count(fcfg: FedsLLMConfig, eta: float) -> int:
    """Lemma 2's count (``delay_model.local_iters``), rounded up, at least 1."""
    return max(1, int(math.ceil(dm.local_iters(fcfg, eta))))


def global_round_count(fcfg: FedsLLMConfig, eta: float) -> int:
    return max(1, int(math.ceil(dm.lemma_a(fcfg) / (1.0 - eta))))


def _later(what: str, needs: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: needs {needs}, which a later slice of the port brings "
                               "(ROADMAP queue 1)")


def build_round_fn(cfg: ModelConfig, fcfg: FedsLLMConfig, cut: int, eta: float,
                   xi: Optional[float] = None, delta: Optional[float] = None,
                   dp_clip: float = 0.0, aggregator: Optional[Callable] = None,
                   compressor=None, two_tier: bool = False, local_algo=None) -> Callable:
    """The global-round function.

    round_fn(state, batches, mask=None, key=None, weights=None, assign=None,
             update_scale=None) -> (state', metrics)

    batches: dict of tensors stacked (K, ...), one micro-dataset per client.
    mask: (K,) survivors, or None. weights: (K,) aggregation weights (e.g.
    D_k), or None (uniform). key is taken for the reference's signature (it
    feeds DP noise, not ported). assign: (K, M) one-hot client→edge
    membership, used only with ``two_tier=True`` (the ``edge-agg``
    topology): every aggregation then runs per edge and across edges
    (``federated.hier_aggregate``); ``assign=None`` aggregates flat.
    update_scale: the server mixing rate α of Δw ← Δw + α·h̄ (a scalar or
    0-d tensor), None for α = 1. aggregator: (stacked, weights=None,
    mask=None) -> tree, ``federated.fedavg`` by default, applied to ḡ and
    to the updates. local_algo: a ``fl.local_algos`` name
    or instance, ``gd`` by default. A stateful one (``scaffold``) takes two
    more arguments and returns a triple:

        round_fn(state, batches, mask, key, weights, assign, update_scale,
                 algo_state, algo_ids) -> (state', metrics, algo_state')

    algo_state: the (K, …)-stacked control variates of the whole population;
    algo_ids: (C,) rows of ``algo_state`` that the cohort's batches belong to
    (None: the first C). The variates advance on the raw deviations h.
    """
    split._require_no_codec(compressor)
    if dp_clip > 0.0:
        raise _later("dp_clip > 0", "core/privacy.py (with the uplink codecs, item 5)")
    xi = fcfg.xi if xi is None else xi
    delta = fcfg.delta if delta is None else delta
    I_loc = local_iteration_count(fcfg, eta)
    aggregate = federated.fedavg if aggregator is None else aggregator
    algo = get_local_algo("gd" if local_algo is None else local_algo)

    def client_grads(base, lc, ls, batch):
        loss, dc, ds, _ = split.split_value_and_grad(base, lc, ls, batch, cfg, cut)
        return loss, (dc, ds)

    def one_client_round(base, lc0, ls0, gk0, gbar, batch, ctrl=None, ctrl_bar=None):
        """I_loc local steps on problem (4) for one client -> (h_c, h_s, last loss)."""
        h = (tree_map(torch.zeros_like, lc0), tree_map(torch.zeros_like, ls0))
        for _ in range(I_loc):
            loss, (dc, ds) = client_grads(base, tree_map(torch.add, lc0, h[0]),
                                          tree_map(torch.add, ls0, h[1]), batch)
            # ∇G = ∇F_k(Δw+h) − ∇F_k(Δw) + ξ∇F(Δw)
            g = (tree_map(lambda a, b, c: a - b + weak(xi, c) * c, dc, gk0[0], gbar[0]),
                 tree_map(lambda a, b, c: a - b + weak(xi, c) * c, ds, gk0[1], gbar[1]))
            g = algo.correct(g, h, ctrl, ctrl_bar)
            h = tree_map(lambda x, gx: x - weak(delta, gx) * gx, h, g)
        return h[0], h[1], loss

    def _round(state: FedsLLMState, batches, mask, weights, assign, update_scale, algo_state,
               algo_ids):
        dev = state.round.device
        K = tree_leaves(batches)[0].shape[0]
        mask = None if mask is None else torch.as_tensor(mask, dtype=torch.float32, device=dev)
        weights = (None if weights is None
                   else torch.as_tensor(weights, dtype=torch.float32, device=dev))
        if two_tier and assign is not None:
            # hierarchical fed-server role: per edge, then across edges
            assign = torch.as_tensor(assign, dtype=torch.float32, device=dev)

            def agg(tree):
                return federated.hier_aggregate(aggregate, tree, assign, weights=weights,
                                                mask=mask)
        else:
            def agg(tree):
                return aggregate(tree, weights=weights, mask=mask)

        # 2. round-start gradients per client (h = 0); ḡ on the fed server
        clients = [tree_index(batches, k) for k in range(K)]
        start = [client_grads(state.base, state.lora_c, state.lora_s, b) for b in clients]
        g0 = tree_stack([g for _, g in start])
        gbar = (agg(g0[0]), agg(g0[1]))

        # 3. local iterations, client by client
        ctrl = ctrl_bar = None
        new_algo_state = algo_state
        if algo.stateful:
            if algo_state is None:
                raise ValueError(f"local algo {algo.name!r} is stateful: pass algo_state= "
                                 "(the (K, …)-stacked control variates)")
            ctrl_bar = tree_map(lambda x: torch.mean(x, dim=0), algo_state)
            ids = (torch.arange(K, device=dev) if algo_ids is None
                   else torch.as_tensor(algo_ids, device=dev).long())
            ctrl = tree_map(lambda x: x[ids], algo_state)
        outs = [one_client_round(state.base, state.lora_c, state.lora_s, g, gbar, b,
                                 ctrl=None if ctrl is None else tree_index(ctrl, k),
                                 ctrl_bar=ctrl_bar)
                for k, ((_, g), b) in enumerate(zip(start, clients))]
        h_c, h_s = tree_stack([o[0] for o in outs]), tree_stack([o[1] for o in outs])
        if algo.stateful:
            # variates advance on the raw deviations; masked clients keep
            # theirs (the algo blends), then go back to their rows
            upd = algo.update_variates(ctrl, ctrl_bar, (h_c, h_s), mask, I_loc, delta)
            new_algo_state = tree_map(lambda full, u: full.index_copy(0, ids, u.to(full.dtype)),
                                      algo_state, upd)

        # 4. aggregate + update (fed server for Δw_c, main server for Δw_s)
        alpha = 1.0 if update_scale is None else update_scale
        new_lc = federated.apply_update(state.lora_c, agg(h_c), alpha)
        new_ls = federated.apply_update(state.lora_s, agg(h_s), alpha)
        metrics = {
            "loss_round_start": torch.mean(torch.stack([loss for loss, _ in start])),
            "loss_local_final": torch.mean(torch.stack([o[2] for o in outs])),
            "h_c_norm": lora_lib.delta_norm(h_c),
        }
        return FedsLLMState(state.base, new_lc, new_ls, state.round + 1), metrics, new_algo_state

    if algo.stateful:
        def round_fn(state: FedsLLMState, batches, mask=None, key=None, weights=None,
                     assign=None, update_scale=None, algo_state=None, algo_ids=None):
            return _round(state, batches, mask, weights, assign, update_scale, algo_state,
                          algo_ids)
    else:
        def round_fn(state: FedsLLMState, batches, mask=None, key=None, weights=None,
                     assign=None, update_scale=None):
            new_state, metrics, _ = _round(state, batches, mask, weights, assign,
                                           update_scale, None, None)
            return new_state, metrics

    round_fn.local_algo = algo
    return round_fn


# ---------------------------------------------------------------------------
# Simulated wall-clock integration (delay model + allocator)
# ---------------------------------------------------------------------------


@dataclass
class RoundTiming:
    """Per-global-round simulated wireless wall-clock (seconds)."""

    compute: np.ndarray  # (K,) eq. (10)
    uplink_fed: np.ndarray  # (K,) t_c
    uplink_main: np.ndarray  # (K,) V·t_s
    total: np.ndarray  # (K,)


def simulate_round_time(fcfg: FedsLLMConfig, net, alloc, eta: float,
                        model_params: Optional[int] = None) -> RoundTiming:
    """Each client's round under ``alloc`` (a ``resource_alloc.Allocation``):
    compute (eq. 10), the fed uplink t_c and V(η) main uplinks of t_s."""
    V = dm.local_iters(fcfg, eta)
    tau = dm.compute_time(fcfg, net, eta, alloc.A, model_params)
    up_f = alloc.t_c
    up_m = V * alloc.t_s
    return RoundTiming(tau, up_f, up_m, tau + up_f + up_m)
