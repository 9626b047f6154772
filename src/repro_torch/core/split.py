"""Split-learning engine (paper Algorithm 2; port of ``repro/core/split.py``).

The model is cut at a group boundary (a group is one copy of the layer
pattern): the client runs embed + groups[:cut]; the main server runs
groups[cut:] + the tail layers + final norm + head + loss. Frozen base
weights live on both sides; only LoRA updates and smashed activations move.

``split_value_and_grad`` keeps the paper's message flow, with autograd in
place of ``jax.vjp``:

    client forward  ->  smashed activations A_k   (uplink, s bits)
    server fwd+bwd  ->  loss, dLoRA_s, dA_k       (downlink gradient)
    client backward ->  dLoRA_c                   (autograd.grad with dA_k)

and equals ``monolithic_value_and_grad``, end-to-end autograd of the same
function. Both sides train through ``lora.merge`` and the plain attention and
SSD paths, never through a kernel (the kernels are forward-only).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import lora as lora_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_like, tree_map


def _grad(out, leaves, grad_outputs=None) -> list:
    """``torch.autograd.grad`` of ``out`` w.r.t. ``leaves``. A side with no
    group (a cut at either end of the stack) holds adapters of zero size,
    outside the graph: they take zero gradients; any other leaf outside the
    graph still raises."""
    live = [t for t in leaves if t.numel()]
    got = iter(torch.autograd.grad(out, live, grad_outputs=grad_outputs) if live else ())
    return [next(got) if t.numel() else torch.zeros_like(t) for t in leaves]


class SplitParts(NamedTuple):
    client_base: Any  # params view with groups[:cut]
    server_base: Any  # params view with groups[cut:] (+ final norm and head)


def slice_base(params, cut: int) -> SplitParts:
    client = dict(params)
    server = dict(params)
    client["groups"] = tree_map(lambda a: a[:cut], params["groups"])
    server["groups"] = tree_map(lambda a: a[cut:], params["groups"])
    return SplitParts(client, server)


def client_forward(client_base, lora_c, batch, cfg: ModelConfig, *, remat=False):
    """The encoder (``encdec``) + embed + the first ``cut`` groups ->
    (smashed activations (B, S, D), the encoder's output or None); for
    ``vlm`` the projected patches are in S. The client's MoE aux loss is
    dropped, as the reference's ``client_forward`` drops it: the split loss
    holds the server's only."""
    merged = lora_lib.merge(client_base, lora_c, cfg)
    enc_out = T._encode(merged, batch, cfg, kernels=False)
    x, positions = T._embed_inputs(merged, batch, cfg)
    x, _ = T._scan_groups(merged, x, cfg, positions=positions, kernels=False, remat=remat,
                          include_tail=False, enc_out=enc_out)
    return x, enc_out


def server_forward_loss(server_base, lora_s, acts, batch, cfg: ModelConfig, *, enc_out=None,
                        remat=False):
    """Remaining groups + tail + final norm + head + CE loss on the main
    server (its ``encdec`` layers cross-attend to ``enc_out``), plus
    0.01·aux of the server's MoE layers (the reference's
    ``server_forward_loss``)."""
    merged = lora_lib.merge(server_base, lora_s, cfg)
    positions = torch.arange(acts.shape[1], device=acts.device)[None, :]
    x, aux = T._scan_groups(merged, acts, cfg, positions=positions, kernels=False, remat=remat,
                            enc_out=enc_out)
    x = L.apply_norm(merged["final_norm"], x, cfg)
    return L.fused_cross_entropy(merged["embed"], x, batch["labels"], cfg,
                                 mask=batch.get("mask")) + 0.01 * aux


def _trainable(lora):
    return tree_map(lambda t: t.detach().requires_grad_(), lora)


def split_value_and_grad(params, lora_c, lora_s, batch, cfg: ModelConfig, cut: int,
                         remat: bool = False, compressor=None):
    """Algorithm-2 message flow. Returns (loss, dlora_c, dlora_s, info).

    ``compressor`` (see ``repro_torch.api.compressors``) is applied to the
    smashed activations on the client→server uplink, *outside* the client's
    graph: the server differentiates w.r.t. the compressed activations and
    the resulting dA_k flows straight through the codec back into the client
    backward pass (straight-through split learning). For ``encdec`` the
    encoder's output crosses the uplink beside the activations, compressed
    alike, and its gradient returns with dA_k. ``info`` holds the
    uplink and downlink volumes (the delay model's s); the allocator's
    ``s_bits`` are rescaled by the codec's nominal ratio up front, in
    ``repro_torch.api.Experiment``."""
    parts = slice_base(params, cut)
    lc, ls = _trainable(lora_c), _trainable(lora_s)
    with torch.enable_grad():
        acts, enc_out = client_forward(parts.client_base, lc, batch, cfg, remat=remat)
        smashed = [t for t in (acts, enc_out) if t is not None]
        # what crosses the uplink
        sent = [t.detach() if compressor is None else compressor.apply(t.detach())
                for t in smashed]
        for t in sent:
            t.requires_grad_()
        loss = server_forward_loss(parts.server_base, ls, sent[0], batch, cfg,
                                   enc_out=sent[1] if enc_out is not None else None, remat=remat)
        n = len(tree_leaves(ls))
        grads = _grad(loss, tree_leaves(ls) + sent)
        dls, dsent = grads[:n], grads[n:]
        # the gradient of the smashed data returns to the client (dA_k)
        dlc = _grad(smashed, tree_leaves(lc), grad_outputs=dsent)
    dacts = dsent[0]
    elems, bits = sum(t.numel() for t in smashed), acts.element_size() * 8
    info = {"smashed_bytes": elems * acts.element_size(),
            "smashed_bits_uplink": elems * bits if compressor is None
            else compressor.bits(elems, bits),
            "grad_bytes": dacts.numel() * dacts.element_size()}
    return loss.detach(), tree_like(lc, dlc), tree_like(ls, dls), info


def monolithic_value_and_grad(params, lora_c, lora_s, batch, cfg: ModelConfig, cut: int):
    """End-to-end autograd of the same two-phase function: must equal
    ``split_value_and_grad``. Returns (loss, dlora_c, dlora_s)."""
    parts = slice_base(params, cut)
    lc, ls = _trainable(lora_c), _trainable(lora_s)
    with torch.enable_grad():
        acts, enc_out = client_forward(parts.client_base, lc, batch, cfg)
        loss = server_forward_loss(parts.server_base, ls, acts, batch, cfg, enc_out=enc_out)
        n = len(tree_leaves(lc))
        grads = _grad(loss, tree_leaves(lc) + tree_leaves(ls))
    return loss.detach(), tree_like(lc, grads[:n]), tree_like(ls, grads[n:])
