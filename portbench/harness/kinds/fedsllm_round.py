"""FedsLLM global rounds (Algorithms 1 + 2) back to back, through the
program's ``core.fedsllm.build_round_fn``, each round's state feeding the
next.

Set-up builds the state (the benchmark's weights and adapters) and the round
function once, and drives them through the first ``checked_rounds`` rounds:
that is the warm-up, and what the check compares. The window goes on from
there with fresh batches. Every round's batches are drawn from the seed by
its index, all rows different.

Check: the plain reference (``reference/round.py``) follows the checked
rounds from the same adapters over the same batches and weights. Numbers:
``loss_gap``, the largest relative gap of a round's mean loss (round start
and last local step); ``update_gap`` and ``change_gap``, the worst leaf's gap
between the program's and the reference's norm of the first round's update
and of the change after the checked rounds, each over the larger of that
leaf's and the median leaf's reference norm. Leaves whose first update in
the reference is under a thousandth of the median leaf's are left out.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.harness import flops
from portbench.harness import weights as W
from portbench.reference.round import fedsllm_round

SIDES = ("client", "server")
NOUGHT = 1e-3  # a leaf whose reference update is under this share of the median leaf's


def local_steps(traffic: dict) -> int:
    """Lemma 2's I_loc = ceil(v·log2(1/η)), v = 2/((2 − Lδ)δγ) with L = γ = 1."""
    d = traffic["delta"]
    return max(1, math.ceil(2.0 / ((2.0 - d) * d) * math.log2(1.0 / traffic["eta"])))


def client_weights(seed: int, traffic: dict) -> list:
    lo, hi = traffic["client_weights"]
    return np.random.default_rng(int(seed)).uniform(lo, hi, traffic["clients"]).tolist()


def batches(seed: int, index: int, traffic: dict, vocab: int, device, fault=None) -> dict:
    """Round ``index``'s batches, stacked (K, B, S); labels are the next tokens."""
    K, B, S = traffic["clients"], traffic["seqs_per_client"], traffic["seq_len"]
    t = W.tokens(seed, index, (K, B, S + 1), vocab, device)
    if fault == "half_batch":  # the mean over the first half of each client's rows
        t = t[:, :B // 2]
    return {"tokens": t[..., :-1].contiguous(), "labels": t[..., 1:].contiguous()}


def flat(lc: dict, ls: dict) -> dict:
    """The program's client and server adapters as float32 leaves
    {(side, projection, "A"|"B"): tensor}."""
    out = {}
    for side, tree in zip(SIDES, (lc, ls)):
        for key, ab in tree.items():
            name = key.split("['")[-1].rstrip("']")
            for k in ("A", "B"):
                out[(side, name, k)] = ab[k].detach().float().clone()
    return out


def flat_reference(ad: dict, cut: int) -> dict:
    out = {}
    for name, ab in ad.items():
        for k in ("A", "B"):
            out[("client", name, k)] = ab[k][:cut]
            out[("server", name, k)] = ab[k][cut:]
    return out


def leaf_gaps(got: dict, want: dict, keep) -> dict:
    """Each kept leaf's |‖got‖ − ‖want‖| over max(‖want‖, the median leaf's ‖want‖)."""
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in want.items()}
    median = float(np.median(list(norms.values())))
    return {k: abs(float(torch.linalg.vector_norm(got[k])) - norms[k]) / max(norms[k], median)
            for k in keep}


class Session:
    def __init__(self, run):
        from repro_torch.config import FedsLLMConfig
        from repro_torch.core import fedsllm, lora as lora_lib

        self.run, cfg, tr = run, run.cell.config, run.cell.traffic
        self.cfg, self.tr, dev = cfg, tr, run.device
        self.K, self.B, self.S = tr["clients"], tr["seqs_per_client"], tr["seq_len"]
        self.I_loc = local_steps(tr)
        if self.I_loc != tr["local_steps"]:
            raise ValueError(f"eta {tr['eta']} gives I_loc {self.I_loc}, not {tr['local_steps']}")
        self.cut = tr["cut"]
        self.w = W.make_weights(cfg, run.seed, dev)
        ad = W.make_adapters(cfg, run.seed, dev, tr["adapter_b_to_w_std"])
        self.ref_ad0 = {n: {k: t.float().clone() for k, t in ab.items()} for n, ab in ad.items()}
        self.weights = client_weights(run.seed, tr)
        # the adapters' state in the type the configuration keeps it (the values drawn in
        # the served type either way)
        held = W.DTYPES[cfg["lora"].get("dtype", cfg["dtype"])]
        ad = {n: {k: t.to(held) for k, t in ab.items()} for n, ab in ad.items()}
        lc, ls = lora_lib.split_client_server(W.program_lora(ad), self.cut)
        self.state = fedsllm.FedsLLMState(W.program_params(self.w), lc, ls,
                                          torch.zeros((), dtype=torch.int32, device=dev))
        fcfg = FedsLLMConfig(num_clients=self.K, xi=tr["xi"], delta=tr["delta"])
        program_steps = fedsllm.local_iteration_count(fcfg, tr["eta"])
        if program_steps != self.I_loc:
            raise RuntimeError(f"the program's I_loc {program_steps} differs from Lemma 2's "
                               f"{self.I_loc}")
        self.round_fn = fedsllm.build_round_fn(W.program_config(cfg), fcfg, self.cut, tr["eta"])
        self.index = 0
        passes = self.K * (1 + self.I_loc)
        self.tokens_per_round = passes * self.B * self.S
        self.flops_per_round = passes * flops.train_pass_flops(cfg, self.B, self.S)
        # the checked rounds, which are the warm-up
        self.snaps, self.losses = [flat(lc, ls)], []
        self.setup_parts, t0 = {}, time.perf_counter()
        for i in range(tr["checked_rounds"]):
            m = self.step()
            self.losses.append({k: float(m[k]) for k in ("loss_round_start", "loss_local_final")})
            self.snaps.append(flat(self.state.lora_c, self.state.lora_s))
            self.setup_parts[f"checked_round_{i}"] = time.perf_counter() - t0

    def step(self):
        """One round through the program's round function; returns its metrics."""
        b = batches(self.run.seed, self.index, self.tr, self.cfg["vocab_size"], self.run.device,
                    self.run.fault)
        new, metrics = self.round_fn(self.state, b, weights=self.weights)
        if self.run.fault != "unchanged":
            self.state = new
        self.index += 1
        return metrics

    def window(self, seconds: float) -> dict:
        """Rounds back to back until ``seconds`` have passed; the window closes
        when the round running then ends."""
        sync = self.run.sync
        steps, start = [], time.perf_counter()
        while time.perf_counter() - start < seconds:
            t0 = time.perf_counter()
            self.step()
            sync()
            steps.append({"t0": t0 - start, "t1": time.perf_counter() - start,
                          "tokens": self.tokens_per_round, "flops": self.flops_per_round})
        return {"steps": steps, "seconds": steps[-1]["t1"], "attempted": len(steps), "failed": 0}

    def traced_part(self) -> dict:
        self.step()
        return {"steps": 1, "forwards": []}  # training runs none of the kernels

    def free(self):
        del self.state, self.round_fn

    def check(self):
        """The numbers compared: the program's checked rounds (with a control
        set, the control's in their place) against the reference's."""
        cfg, tr, dev = self.cfg, self.tr, self.run.device
        kw = dict(I_loc=self.I_loc, xi=tr["xi"], delta=tr["delta"])
        n = tr["checked_rounds"]
        refs, ref_losses, ad = [flat_reference(self.ref_ad0, self.cut)], [], self.ref_ad0
        for i in range(n):
            data = batches(self.run.seed, i, tr, cfg["vocab_size"], dev)
            pairs = list(zip(data["tokens"], data["labels"]))
            ad, losses = fedsllm_round(cfg, self.w, ad, pairs, self.weights, **kw)
            refs.append(flat_reference(ad, self.cut))
            ref_losses.append({k: float(v) for k, v in losses.items()})
        got, got_losses = self.snaps, self.losses
        if self.run.control:
            got, got_losses, ad = [refs[0]], [], self.ref_ad0
            for i in range(n):
                data = batches(self.run.seed, i, tr, cfg["vocab_size"], dev)
                pairs = list(zip(data["tokens"], data["labels"]))
                ad, losses = fedsllm_round(cfg, self.w, ad, pairs, self.weights,
                                           quant=self.run.control, **kw)
                got.append(flat_reference(ad, self.cut))
                got_losses.append({k: float(v) for k, v in losses.items()})
        d1_ref = {k: refs[1][k] - refs[0][k] for k in refs[0]}
        norms = {k: float(torch.linalg.vector_norm(v)) for k, v in d1_ref.items()}
        median = float(np.median(list(norms.values())))
        keep = [k for k, v in norms.items() if v >= NOUGHT * median]
        self.left_out = sorted(set(norms) - set(keep))
        loss_gap = max(abs(g[k] - r[k]) / abs(r[k]) for g, r in zip(got_losses, ref_losses)
                       for k in r)
        update = leaf_gaps({k: got[1][k] - got[0][k] for k in keep}, d1_ref, keep)
        change = leaf_gaps({k: got[n][k] - got[0][k] for k in keep},
                           {k: refs[n][k] - refs[0][k] for k in refs[0]}, keep)
        self.diag = {"update_median": float(np.median(list(update.values()))),
                     "change_median": float(np.median(list(change.values()))),
                     "update_leaves": sorted(([v, "/".join(k)] for k, v in update.items()),
                                             reverse=True),
                     "change_leaves": sorted(([v, "/".join(k)] for k, v in change.items()),
                                             reverse=True)}
        return {"loss_gap": loss_gap, "update_gap": max(update.values()),
                "change_gap": max(change.values())}
