"""Privacy mechanisms for the FedsLLM uplink (port of ``repro/core/privacy.py``).

The paper's Fig. 1 includes a client-side *noise layer* on the smashed
activations, and its delay model assumes "no privacy protection measures
such as noise layers or differential privacy" when pricing the round:
privacy is part of the framework but priced out of §III. This module
supplies both mechanisms:

  * ``clip_and_noise_updates``: DP for the fed-server upload (per-client L2
    clipping + Gaussian mechanism, Abadi et al. 2016): the fed server
    aggregates mean_k clip(h_k, c) + N(0, σ²c²/K);
  * ``noise_layer``: the paper's smashed-activation noise (additive Gaussian
    at the split boundary, scaled to the activation RMS).
The reference's ``privacy_cost`` (ε accounting) is not ported: nothing on
the port's path reads it.

Noise is drawn from a ``torch.Generator`` (the reference's ``jax.random``
draws cannot be reproduced in torch: the law is the same, the values are
not). A CPU generator draws on the CPU and the noise moves to the tensor's
device, so the same generator gives the same noise on every device.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_like, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in fp32 (the reference's ``optim.grad_utils``)."""
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(sum(sq) if sq else torch.zeros(()))


def _clip_scale(norm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """min(1, c/max(‖h‖, 1e-12)), a true division as the reference's."""
    return torch.clamp(norm.new_tensor(clip_norm) / torch.clamp(norm, min=1e-12), max=1.0)


def clip_tree(tree, clip_norm: float):
    """Per-client L2 clip: h ← h · min(1, c/‖h‖)."""
    scale = _clip_scale(global_norm(tree), clip_norm)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree)


def _normal(shape, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def clip_and_noise_updates(stacked, gen: torch.Generator, *, clip_norm: float = 1.0,
                           noise_multiplier: float = 0.0):
    """DP-FedAvg preprocessing on stacked (K, ...) client updates.

    Clips every client's update to ``clip_norm`` and adds Gaussian noise
    N(0, (σ·c)²) to the SUM (so the mean sees σ·c/K, standard DP-FedAvg).
    Returns the processed stacked tree (aggregate with federated.fedavg)."""
    leaves = tree_leaves(stacked)
    K = leaves[0].shape[0]
    sq = sum(torch.sum(torch.square(x.float()).reshape(K, -1), dim=1) for x in leaves)
    scale = _clip_scale(torch.sqrt(sq), clip_norm)
    clipped = [(x.float() * scale.reshape((K,) + (1,) * (x.ndim - 1))).to(x.dtype)
               for x in leaves]
    if noise_multiplier > 0.0:
        std = noise_multiplier * clip_norm  # noise on the sum
        noisy = []
        for leaf in clipped:
            # on client 0's slot: mean_k(x) + N(0, (σc)²)/K == fedavg(noisy)
            n = _normal(leaf.shape[1:], gen, leaf.device) * std
            noisy.append(torch.cat([(leaf[0] + n.to(leaf.dtype))[None], leaf[1:]]))
        clipped = noisy
    return tree_like(stacked, clipped)


def noise_layer(acts: torch.Tensor, gen: torch.Generator, *, snr_db: float = 20.0) -> torch.Tensor:
    """The paper's client-side noise layer on smashed activations: additive
    Gaussian scaled to the activation RMS at the given SNR."""
    rms = torch.sqrt(torch.mean(torch.square(acts.float())) + 1e-12)
    sigma = rms * (10.0 ** (-snr_db / 20.0))
    return acts + (sigma * _normal(acts.shape, gen, acts.device)).to(acts.dtype)

