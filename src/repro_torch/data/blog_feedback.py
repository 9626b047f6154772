"""BlogFeedback dataset surrogate (paper ref. [12], Buza 2014; port of
``repro/data/blog_feedback.py``).

The paper simulates on the UCI BlogFeedback dataset: 60 021 samples, 281
dims (280 features + target = comments in next 24 h).  Nothing is
downloaded: a statistically matched surrogate is synthesised from a seed,
heavy-tailed sparse features (real BlogFeedback is mostly zero-inflated
counts) and a target generated by a sparse noisy linear model, preserving
the shape, scale, and the strongly-convex regression structure the paper's
Lemmas assume.  The numpy generation is the reference's, bit for bit; the
loss is torch.  The loader API matches a real-file loader (drop-in
replaceable)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

NUM_SAMPLES = 60_021
NUM_DIMS = 281  # 280 features + 1 target


@dataclass
class BlogFeedback:
    num_samples: int = NUM_SAMPLES
    num_features: int = NUM_DIMS - 1
    seed: int = 0
    _X: Optional[np.ndarray] = field(default=None, repr=False)
    _y: Optional[np.ndarray] = field(default=None, repr=False)

    def _materialise(self):
        if self._X is not None:
            return
        rng = np.random.default_rng(self.seed)
        n, d = self.num_samples, self.num_features
        # zero-inflated log-normal counts (blog comment statistics)
        mask = rng.random((n, d)) < 0.25
        vals = np.exp(rng.normal(0.0, 1.0, size=(n, d))).astype(np.float32)
        X = (mask * vals).astype(np.float32)
        X /= np.maximum(X.std(axis=0, keepdims=True), 1e-6)
        w_true = (rng.random(d) < 0.1) * rng.normal(0.0, 1.0, size=d)
        y = X @ w_true + 0.5 * rng.normal(size=n)
        self._X, self._y = X, y.astype(np.float32)

    @property
    def X(self) -> np.ndarray:
        self._materialise()
        return self._X

    @property
    def y(self) -> np.ndarray:
        self._materialise()
        return self._y

    def client_shard(self, k: int, num_clients: int):
        """Paper: equal selection probability — uniform contiguous shards."""
        n = self.num_samples // num_clients
        lo = k * n
        return self.X[lo : lo + n], self.y[lo : lo + n]


def ridge_loss_fn(lmbda: float = 1e-2):
    """Strongly-convex regression loss matching assumption (7): with ridge
    λ‖w‖², the Hessian satisfies λI ≼ ∇²F ≼ (σ_max(XᵀX/n)+λ)I. Takes
    tensors (``torch.from_numpy`` of ``X``, ``y``)."""

    def loss(w, X, y):
        r = X @ w - y
        return 0.5 * torch.mean(r * r) + 0.5 * lmbda * torch.sum(w * w)

    return loss
