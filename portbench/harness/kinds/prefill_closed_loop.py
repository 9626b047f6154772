"""Document prefill, one greedy token per document, as a closed loop:
``clients`` clients each keep one document in flight and send the next as
soon as the token of the last one reaches them. The server batches
``batch`` waiting documents, oldest first, into one prefill through the
program's ``serving.decode.make_prefill_fn`` with the adapters unmerged (the
fused LoRA kernel and flash attention on the card). ``clients`` is a
multiple of ``batch``, so every batch is full: the shape warmed up. Every
prompt has ``prompt_len`` tokens; request i's is row i % ``CHUNK`` of chunk
i // ``CHUNK``, each chunk drawn from the seed by its index, so a run's
prompts depend on the seed alone, however many it serves.

Time to first token: from a request's submission to its batch's tokens on
the host.

Check: a sample of the window's finished requests, drawn from the seed, and
for each the gap by which its served token's logit lies below the best logit
of the plain reference (``reference/model.py``) at the prompt's last
position. Number: ``token_gap``, the widest such gap.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from portbench.harness import flops
from portbench.harness import weights as W
from portbench.reference.model import last_logits

SPARE = 1  # the token stream of the warm-up's and the traced part's prompts
CHUNKS = 2  # the first stream of the window's prompt chunks
CHUNK = 256  # prompts a chunk: a multiple of every batch


class Session:
    def __init__(self, run):
        from repro_torch.models import transformer as T
        from repro_torch.serving.decode import make_prefill_fn

        self.run, cfg, tr = run, run.cell.config, run.cell.traffic
        self.cfg, self.tr, dev = cfg, tr, run.device
        self.B, self.S, self.clients = tr["batch"], tr["prompt_len"], tr["clients"]
        if self.clients % self.B or CHUNK % self.B:
            raise ValueError(f"clients {self.clients} and the chunk {CHUNK} have to be "
                             f"multiples of the batch {self.B}")
        self.w = W.make_weights(cfg, run.seed, dev)
        self.ad = W.make_adapters(cfg, run.seed, dev, tr["adapter_b_to_w_std"])
        self.params, self.lora = W.program_params(self.w), W.program_lora(self.ad)
        pcfg = W.program_config(cfg)
        self.cache = T.init_cache(pcfg, self.B, self.S, device=dev)
        self.prefill = make_prefill_fn(pcfg)
        self.chunks = {}
        self.prompts(0)
        extra = self.B * (tr["warm_batches"] + tr["traced_batches"])
        self.spare = W.tokens(run.seed, SPARE, (extra, self.S), cfg["vocab_size"], dev)
        self.flops_per_batch = flops.forward_flops(cfg, self.B, self.S, 1)
        self.served = {}  # request id -> token
        self.used_spare = 0
        for _ in range(tr["warm_batches"]):
            self.serve_spare()
        run.sync()

    def prompts(self, first: int, n: int = 1) -> torch.Tensor:
        """The prompts of requests first .. first + n - 1, one chunk's rows."""
        c, i = divmod(first, CHUNK)
        if i + n > CHUNK:
            raise ValueError("a batch's prompts lie in one chunk")
        if c not in self.chunks:
            self.chunks[c] = W.tokens(self.run.seed, CHUNKS + c, (CHUNK, self.S),
                                      self.cfg["vocab_size"], self.run.device)
        return self.chunks[c][i:i + n]

    def serve(self, prompts) -> list:
        """One prefill of a (B, S) batch; the served tokens on the host."""
        with torch.no_grad():
            state = self.prefill(self.params, {"tokens": prompts}, self.cache, self.lora)
        tokens = state.tokens[:, 0].tolist()
        if self.run.fault == "token_altered":
            tokens[0] = (tokens[0] + 1) % self.cfg["vocab_size"]
        return tokens

    def serve_spare(self):
        """A batch of the prompts kept apart from the window's (in turn)."""
        i = self.used_spare % self.spare.shape[0]
        self.used_spare += self.B
        return self.serve(self.spare[i:i + self.B])

    def window(self, seconds: float) -> dict:
        """Every client submits at the window's start; a batch starts while
        fewer than ``seconds`` have passed, and the window closes when the
        last one ends. The requests submitted at its close are not served."""
        waiting = deque((i, 0.0) for i in range(self.clients))  # (request id, submitted at)
        nxt, steps, latency = self.clients, [], []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            batch = [waiting.popleft() for _ in range(self.B)]
            t0 = time.perf_counter() - start
            tokens = self.serve(self.prompts(batch[0][0], self.B))
            t1 = time.perf_counter() - start
            for (i, submitted), tok in zip(batch, tokens):
                self.served[i] = tok
                latency.append(t1 - submitted)
                waiting.append((nxt, t1))
                nxt += 1
            steps.append({"t0": t0, "t1": t1, "tokens": self.B * self.S,
                          "flops": self.flops_per_batch, "requests": self.B})
        return {"steps": steps, "seconds": steps[-1]["t1"] if steps else seconds,
                "attempted": len(self.served), "failed": 0, "latency_s": latency}

    def traced_part(self) -> dict:
        n = self.tr["traced_batches"]
        for _ in range(n):
            self.serve_spare()
        return {"steps": n, "forwards": [(self.B, self.S)] * n}

    def free(self):
        del self.cache, self.params, self.lora

    def sample(self) -> list:
        """The finished requests the check reads: ``check_requests`` of them
        drawn from the seed (every prompt has the same, longest, length)."""
        done = sorted(self.served)
        rng = np.random.default_rng(int(self.run.seed))
        k = min(self.tr["check_requests"], len(done))
        return sorted(rng.choice(done, size=k, replace=False).tolist())

    def check(self) -> dict:
        ids = self.sample()
        if not ids:
            return {"token_gap": float("inf")}
        prompts = torch.cat([self.prompts(i) for i in ids])
        rows = self.tr["reference_rows"]
        ref = last_logits(self.cfg, self.w, self.ad, prompts, rows=rows)
        if self.run.control:  # the control's first token in the program's place
            low = last_logits(self.cfg, self.w, self.ad, prompts, rows=rows,
                              quant=self.run.control)
            served = torch.argmax(low, dim=-1)
        else:
            served = torch.tensor([self.served[i] for i in ids], device=ref.device)
        gaps = ref.max(dim=-1).values - ref.gather(1, served[:, None])[:, 0]
        return {"token_gap": float(gaps.max())}
