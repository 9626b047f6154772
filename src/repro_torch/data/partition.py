"""Federated data partitioners, IID and Dirichlet non-IID (port of
``repro/data/partition.py``: the same numpy code, so the same splits)."""

from __future__ import annotations

import numpy as np


def iid_partition(n: int, num_clients: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(idx, num_clients)]


def dirichlet_partition(labels: np.ndarray, num_clients: int, alpha: float = 0.5,
                        seed: int = 0, min_size: int = 2) -> list[np.ndarray]:
    """Label-skewed non-IID split: per-class Dirichlet(α) proportions."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    for _ in range(100):
        buckets: list[list[int]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * num_clients)
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for b, part in zip(buckets, np.split(idx, cuts)):
                b.extend(part.tolist())
        sizes = [len(b) for b in buckets]
        if min(sizes) >= min_size:
            return [np.sort(np.array(b, dtype=np.int64)) for b in buckets]
    raise ValueError(
        f"dirichlet_partition could not give every one of {num_clients} "
        f"clients >= {min_size} samples in 100 draws (alpha={alpha}, "
        f"n={len(labels)}; last draw's sizes: {sizes}) — lower min_size, "
        f"raise alpha, or provide more samples")
