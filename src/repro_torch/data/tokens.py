"""Deterministic synthetic LM token pipeline (port of ``repro/data/tokens.py``).

The reference's recipe, drawn from ``torch.Generator``s (its ``jax.random``
draws cannot be reproduced in torch, so the tokens differ while their law is
the same): a learnable bigram stream, where each next token is a fixed
permutation of the last (a function of the vocabulary only) with probability
``structure`` and uniform otherwise; labels are the tokens shifted left, the
first token wrapping to the end. Batches are index-addressable by (seed,
step) and drawn on the CPU, so the same step gives the same batch on every
device; they are then moved to ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_stack

PERM_SEED = 1234  # the bigram permutation's seed, as in the reference


def synthetic_lm_batch(gen: torch.Generator, batch: int, seq: int, vocab: int,
                       structure: float = 0.8, device="cuda"):
    """{"tokens", "labels"} (batch, seq) int64 and "mask" (batch, seq) fp32 ones."""
    perm = torch.randperm(vocab, generator=torch.Generator().manual_seed(PERM_SEED))
    first = torch.randint(0, vocab, (batch,), generator=gen)
    rnd = torch.randint(0, vocab, (batch, seq - 1), generator=gen)
    use_det = torch.rand((batch, seq - 1), generator=gen) < structure
    toks = [first]
    for i in range(seq - 1):
        toks.append(torch.where(use_det[:, i], perm[toks[-1]], rnd[:, i]))
    tokens = torch.stack(toks, dim=1)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    device = resolve_device(device)
    return {"tokens": tokens.to(device), "labels": labels.to(device),
            "mask": torch.ones((batch, seq), dtype=torch.float32, device=device)}


@dataclass
class TokenStream:
    """Stateless, index-addressable batch source (resume = remember step)."""

    batch: int
    seq: int
    vocab: int
    seed: int = 0
    structure: float = 0.8
    device: str = "cuda"

    def batch_at(self, step: int):
        # a torch.Generator keeps 32 bits of its seed: hash (seed, step) into them
        key = np.random.SeedSequence([self.seed, step]).generate_state(1)[0]
        gen = torch.Generator().manual_seed(int(key))
        return synthetic_lm_batch(gen, self.batch, self.seq, self.vocab, self.structure,
                                  self.device)

    def __iter__(self) -> Iterator:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def client_batches(stream: TokenStream, step: int, num_clients: int):
    """Stacked (K, B, S) batches, one slice per federated client."""
    return tree_stack([stream.batch_at(step * num_clients + k) for k in range(num_clients)])
