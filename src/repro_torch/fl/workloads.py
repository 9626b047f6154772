"""Data-heterogeneity workloads — first-class non-IID client data (port of
``repro/fl/workloads.py``: the same numpy draws, so the same per-client
stream positions, pools, lengths and shards).

Every campaign so far fed clients IID slices of one synthetic
:class:`~repro_torch.data.tokens.TokenStream`, so the local-update algorithms in
:mod:`repro_torch.fl.local_algos` (and the aggregators/schedules above them)
could never disagree — there is no client drift to correct.  A *workload*
decides what data each simulated client actually sees, in the three
heterogeneity modes FedLLM-Bench-style splits measure on real federated
LLM corpora:

  ``iid``            each client reads its own fresh positions of the
                     stream — bit-identical to the legacy
                     ``campaign.stream_batcher`` (tests pin this)
  ``quantity-skew``  Dirichlet(α) quantity split: client k owns a finite
                     pool of n_k batches (n_k ∝ a Dirichlet draw) and
                     cycles it, so small-pool clients revisit the same few
                     batches every round (quantity/participation skew)
  ``length-skew``    per-client sequence budget: client k's loss mask is
                     truncated to a fixed fraction of the sequence, so
                     clients train on systematically different effective
                     lengths (FedLLM-Bench's length diversity)
  ``dirichlet``      domain skew: a pool of ``num_domains`` distinct
                     synthetic domains (different bigram ``structure``
                     levels and seeds) is Dirichlet-partitioned across
                     clients via :func:`repro_torch.data.partition
                     .dirichlet_partition`, so each client's token
                     distribution is dominated by its own domains

A workload is *pure in (stream.seed, client, round)*: client k's batch at
round r never depends on who else was sampled into the cohort, so elastic
cohorts, straggler masks and checkpoint resume stay bit-reproducible.  ``batcher(stream, K)`` returns
the same ``fn(round_idx, client_ids) -> stacked pytree`` contract the
campaign engine's data sources use; ``params()`` feeds the campaign
checkpoint identity like schedule/local-algo params do.

Unknown names raise ``KeyError`` listing the knowns, like every registry.
"""

from __future__ import annotations

from typing import Any, Callable, Union

import dataclasses

import numpy as np
import torch

from repro_torch.data.partition import dirichlet_partition
from repro_torch.registry import Registry
from repro_torch.tree import tree_stack

workloads: Registry = Registry("workload")

# seed offsets separating this module's host-side RNG draws from every other
# consumer of the stream seed (cohorts, channels, DP all use other streams)
_QUANTITY_TAG = 0x51AD
_LENGTH_TAG = 0x1E57
_DOMAIN_TAG = 0xD0
_DOMAIN_SEED_STRIDE = 9973


def _stack(per_client: list) -> Any:
    return tree_stack(per_client)


class Workload:
    """Strategy protocol for the per-client data distribution."""

    name = "base"

    def params(self) -> dict:
        return {}

    def batcher(self, stream, num_clients: int) -> Callable[[int, np.ndarray], Any]:
        """``fn(round_idx, client_ids) -> (C, ...)``-stacked pytree."""
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        kv = ", ".join(f"{k}={v!r}" for k, v in sorted(self.params().items()))
        return f"{type(self).__name__}({kv})"


@workloads.register("iid")
class IIDWorkload(Workload):
    """Fresh IID positions — client k reads ``r·K + k`` of the stream.

    Bit-identical to the legacy ``campaign.stream_batcher`` path (and to
    ``data.tokens.client_batches`` when the cohort is the full population).
    """

    name = "iid"

    def batcher(self, stream, num_clients: int):
        def fn(round_idx: int, client_ids: np.ndarray):
            return _stack([stream.batch_at(round_idx * num_clients + int(k))
                           for k in client_ids])

        return fn


@workloads.register("quantity-skew")
class QuantitySkewWorkload(Workload):
    """Dirichlet(α) quantity split over finite per-client batch pools.

    Client k owns ``n_k`` distinct stream positions, where the pool sizes
    follow a Dirichlet(α) draw over a total budget of ``pool_rounds`` rounds
    of data per client on average; at round r it serves position
    ``(r mod n_k)·K + k``.  Large α ⇒ near-equal pools; small α ⇒ a few
    data-rich clients and many clients grinding the same handful of batches
    (the drift regime FedProx's proximal term targets).
    """

    name = "quantity-skew"

    def __init__(self, alpha: float = 0.5, pool_rounds: int = 16):
        self.alpha = float(alpha)
        self.pool_rounds = int(pool_rounds)

    def params(self) -> dict:
        return {"alpha": self.alpha, "pool_rounds": self.pool_rounds}

    def pool_sizes(self, seed: int, num_clients: int) -> np.ndarray:
        rng = np.random.default_rng(seed + _QUANTITY_TAG)
        props = rng.dirichlet([self.alpha] * num_clients)
        total = self.pool_rounds * num_clients
        return np.maximum(1, np.round(props * total).astype(int))

    def batcher(self, stream, num_clients: int):
        sizes = self.pool_sizes(stream.seed, num_clients)

        def fn(round_idx: int, client_ids: np.ndarray):
            return _stack([
                stream.batch_at((round_idx % int(sizes[int(k)])) * num_clients
                                + int(k))
                for k in client_ids])

        return fn


@workloads.register("length-skew")
class LengthSkewWorkload(Workload):
    """Per-client sequence-length budgets via the loss mask.

    Client k trains every round on the leading ``L_k = max(1, ⌈f_k·S⌉)``
    tokens of its IID batch — ``f_k`` drawn once per population from
    Uniform[min_frac, 1] — by zeroing the loss mask past ``L_k``.  Token
    content stays the IID stream (the masked mean keeps loss scales
    comparable); what differs across clients is which context lengths their
    gradients ever see.
    """

    name = "length-skew"

    def __init__(self, min_frac: float = 0.25):
        if not 0.0 < min_frac <= 1.0:
            raise ValueError(f"min_frac={min_frac} must be in (0, 1]")
        self.min_frac = float(min_frac)

    def params(self) -> dict:
        return {"min_frac": self.min_frac}

    def length_fracs(self, seed: int, num_clients: int) -> np.ndarray:
        rng = np.random.default_rng(seed + _LENGTH_TAG)
        return rng.uniform(self.min_frac, 1.0, size=num_clients)

    def batcher(self, stream, num_clients: int):
        fracs = self.length_fracs(stream.seed, num_clients)
        lengths = np.maximum(1, np.ceil(fracs * stream.seq)).astype(int)
        pos = np.arange(stream.seq)

        def fn(round_idx: int, client_ids: np.ndarray):
            per_client = []
            for k in client_ids:
                b = dict(stream.batch_at(round_idx * num_clients + int(k)))
                keep = torch.as_tensor(pos < lengths[int(k)], dtype=torch.float32,
                                       device=b["mask"].device)
                b["mask"] = b["mask"] * keep[None, :]
                per_client.append(b)
            return _stack(per_client)

        return fn


@workloads.register("dirichlet")
class DirichletDomainWorkload(Workload):
    """Dirichlet(α) domain skew over distinct synthetic domains.

    A pool of ``num_domains × domain_pool`` shards — shard s lives in
    domain ``s // domain_pool``, each domain a :class:`TokenStream` with its
    own seed and its own bigram ``structure`` level (genuinely different
    token distributions, not just different draws) — is label-partitioned
    across clients with :func:`repro_torch.data.partition.dirichlet_partition`.
    Each client cycles its own shard list across rounds, so small α gives
    clients dominated by one domain (the drift regime SCAFFOLD's control
    variates target) and large α recovers a near-uniform mixture.
    """

    name = "dirichlet"

    def __init__(self, alpha: float = 0.5, num_domains: int = 4,
                 domain_pool: int = 32):
        self.alpha = float(alpha)
        self.num_domains = int(num_domains)
        self.domain_pool = int(domain_pool)

    def params(self) -> dict:
        return {"alpha": self.alpha, "num_domains": self.num_domains,
                "domain_pool": self.domain_pool}

    def client_shards(self, seed: int, num_clients: int) -> list[np.ndarray]:
        total = self.num_domains * self.domain_pool
        if total < num_clients:
            raise ValueError(
                f"num_domains·domain_pool = {total} shards cannot cover "
                f"{num_clients} clients at min_size=1")
        labels = np.repeat(np.arange(self.num_domains), self.domain_pool)
        return dirichlet_partition(labels, num_clients, alpha=self.alpha,
                                   seed=seed + _DOMAIN_TAG, min_size=1)

    def domain_streams(self, stream) -> list:
        # distinct structure levels ⇒ distinct bigram determinism per domain;
        # every other field of the stream (its device) carries over
        levels = np.linspace(0.55, 0.95, self.num_domains)
        return [dataclasses.replace(stream, seed=stream.seed + _DOMAIN_SEED_STRIDE * (d + 1),
                                    structure=float(levels[d]))
                for d in range(self.num_domains)]

    def batcher(self, stream, num_clients: int):
        shards = self.client_shards(stream.seed, num_clients)
        streams = self.domain_streams(stream)

        def fn(round_idx: int, client_ids: np.ndarray):
            per_client = []
            for k in client_ids:
                own = shards[int(k)]
                s = int(own[round_idx % len(own)])
                d, p = divmod(s, self.domain_pool)
                per_client.append(streams[d].batch_at(p))
            return _stack(per_client)

        return fn


def get_workload(spec: Union[str, Workload, type], **kw) -> Workload:
    """Resolve a workload name / class / instance (KeyError lists knowns)."""
    if isinstance(spec, Workload):
        if kw:
            raise TypeError("pass kwargs with a name, not an instance")
        return spec
    if isinstance(spec, type) and issubclass(spec, Workload):
        return spec(**kw)
    cls = workloads.get(spec)
    return cls(**kw)
