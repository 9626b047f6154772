"""The plain reference against the port's own CPU paths at a tiny fp32 size,
on the benchmark's weights: the prefill's logits and a FedsLLM round."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench.harness import weights as W
from portbench.harness.kinds import fedsllm_round as R
from portbench.reference.model import last_logits
from portbench.reference.round import fedsllm_round
from repro_torch.config import FedsLLMConfig
from repro_torch.core import fedsllm, lora as lora_lib
from repro_torch.models import transformer as T

BASE = {"name": "tiny", "num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 16, "d_ff": 128, "vocab_size": 256, "mlp": "swiglu", "norm": "rmsnorm",
        "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "partial_rotary_factor": 1.0,
        "rope_scaling": None, "dtype": "float32",
        "lora": {"rank": 4, "alpha": 8.0, "targets": ["wq", "wk", "wv", "wo", "w_gate", "w_up",
                                                       "w_down"]}}


@pytest.mark.parametrize("tied", [False, True])
def test_program_layout_matches_the_programs_own_init(tied):
    cfg = dict(BASE, tie_embeddings=tied)
    got = W.program_params(W.make_weights(cfg, 1, "cpu"))
    want = T.init_params(W.program_config(cfg), device="meta")
    flat = lambda t, p=(): ([(p, t.shape)] if not isinstance(t, dict)
                            else [x for k in sorted(t) for x in flat(t[k], p + (k,))])
    assert flat(got) == flat(want)


@pytest.mark.parametrize("tied", [False, True])
def test_prefill_logits_match_the_port(tied):
    cfg = dict(BASE, tie_embeddings=tied)
    w, ad = W.make_weights(cfg, 5, "cpu"), W.make_adapters(cfg, 5, "cpu", 0.5)
    tokens = W.tokens(5, 0, (3, 24), cfg["vocab_size"], "cpu")
    pcfg = W.program_config(cfg)
    logits, _ = T.prefill(W.program_params(w), {"tokens": tokens}, pcfg,
                          T.init_cache(pcfg, 3, 24, device="cpu"), lora=W.program_lora(ad))
    ref = last_logits(cfg, w, ad, tokens, rows=2)
    assert torch.allclose(logits[:, -1], ref, atol=2e-5, rtol=1e-5)


def test_round_matches_the_ports_round():
    cfg = dict(BASE, tie_embeddings=False)
    tr = {"clients": 3, "seqs_per_client": 2, "seq_len": 12, "eta": 0.9, "xi": 0.1, "delta": 0.1}
    w, ad = W.make_weights(cfg, 9, "cpu"), W.make_adapters(cfg, 9, "cpu", 0.5)
    weights = [0.7, 1.2, 0.9]
    data = R.batches(9, 0, tr, cfg["vocab_size"], "cpu")
    ref_ad = {n: {k: t.clone() for k, t in ab.items()} for n, ab in ad.items()}
    new, losses = fedsllm_round(cfg, w, ref_ad, list(zip(data["tokens"], data["labels"])),
                                weights, I_loc=2, xi=0.1, delta=0.1)
    lc, ls = lora_lib.split_client_server(W.program_lora(copy.deepcopy(ad)), 1)
    state = fedsllm.FedsLLMState(W.program_params(w), lc, ls, torch.zeros((), dtype=torch.int32))
    fn = fedsllm.build_round_fn(W.program_config(cfg), FedsLLMConfig(num_clients=3), 1, 0.9)
    state, m = fn(state, data, weights=weights)
    got = R.flat(state.lora_c, state.lora_s)
    want = R.flat_reference(new, 1)
    for k in want:
        assert torch.allclose(got[k], want[k], atol=1e-6, rtol=1e-5), k
    for k in losses:
        assert float(m[k]) == pytest.approx(float(losses[k]), rel=1e-6)


def test_lemma_2_local_steps():
    assert R.local_steps({"delta": 0.1, "eta": 0.9}) == 2
    assert fedsllm.local_iteration_count(FedsLLMConfig(), 0.9) == 2
    assert R.local_steps({"delta": 0.1, "eta": 0.5}) == fedsllm.local_iteration_count(
        FedsLLMConfig(), 0.5)
