"""Aggregator registry: the fed-server reduction of Algorithm 1 (port of
``repro/api/aggregators.py``).

Every aggregator has the signature

    aggregate(stacked, weights=None, mask=None) -> tree

where ``stacked`` holds leaves ``(K, ...)``, ``weights`` is an optional
``(K,)`` tensor (e.g. client data sizes D_k) and ``mask`` an optional
``(K,)`` 0/1 survivor mask.

Registered strategies:
  fedavg        uniform mean (Algorithm 1 as written; ignores weights)
  weighted      D_k-weighted FedAvg (the paper's data-size weighting)
  median        coordinate-wise median, mask-aware (robust)
  trimmed_mean  coordinate-wise β-trimmed mean, mask-aware (robust)
  staleness     staleness-aware weighted FedAvg (the async schedules fold
                the discount into the weights)
"""

from __future__ import annotations

from repro_torch.core import federated
from repro_torch.registry import Registry

aggregators: Registry = Registry("aggregator")


@aggregators.register("fedavg")
def _fedavg_uniform(stacked, weights=None, mask=None):
    """Uniform FedAvg: Algorithm 1's (1/K)·Σ, weights intentionally ignored."""
    return federated.fedavg(stacked, mask=mask)


@aggregators.register("weighted")
def _fedavg_weighted(stacked, weights=None, mask=None):
    """Data-size-weighted FedAvg: Σ D_k·h_k / Σ D_k (uniform if weights=None)."""
    return federated.fedavg(stacked, weights=weights, mask=mask)


# the mean family takes hier_aggregate's batched fast path; "uniform"
# members ignore the weights argument (Algorithm 1 as written)
_fedavg_uniform.mean_family = "uniform"
_fedavg_weighted.mean_family = "weighted"

aggregators.register("median")(federated.coordinate_median)
aggregators.register("trimmed_mean")(federated.trimmed_mean)
aggregators.register("staleness")(federated.staleness_weighted)


def get_aggregator(name: str):
    return aggregators.get(name)
