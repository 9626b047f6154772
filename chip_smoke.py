#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Two serving paths, each at full width and depth: ``fedsllm-100m`` (dense,
fused LoRA + flash attention) and ``mamba2-130m`` (SSM, fused LoRA + the SSD
chunked scan); then the training path, one FedsLLM global round, its pricing
and campaigns; then the CLIs and examples. Phases,
each of which fails the run (non-zero exit) on any miss:
  1. build   — compile every CUDA kernel from ``src/repro_torch/csrc`` (one
               nvcc per source, all at once);
then, for each serving path:
  2. kernels — each of its kernels against its plain PyTorch version on the
               card at the path's shapes, with stated tolerances, in bf16
               and through the fp32 variants (and a LoRA rank of 80 in
               bf16, on prefill and decode);
  3. slice   — the model (bf16, batch 8, prompt 512, 32 new tokens, random
               weights and non-zero adapters from seeded generators) served
               once through ``decode_tokens``, every kernel's launch count
               (and per-variant count) set to 0 just before and read just
               after: every LoRA launch must go through the prefill or decode
               variant, every flash and SSD launch through its wgmma variant; then
               the kernel path's prefill/decode logits against the plain path
               (merged weights, ``_attend_full`` / ``ssd_chunked``) and
               against fp32;
  4. timings — CUDA-event times (``ms``), CUDA-graph replay times
               (``graph_ms``) and ``torch.profiler`` device times
               (``device_ms``: a trace is kept only when every kernel name
               has its one-call count times the calls, and a time below
               the bound is refused; else the graph's time, as
               ``device_ms_by`` says) of each
               kernel, its plain version and one library call (where one
               exists) at the path's shapes, beside
               the least time the card could take and the first port's time
               for the same kernel, and the host's cost of a LoRA launch (``host_ms``);
               prefill ms and decode tokens/s;
then
  4b. wide   — two serves of configs outside the kernels' compiled widths,
               at full width and depth (B=8, prompt 512, 32 new tokens):
               fedsllm-100m with 8 heads of 96 over 4 (flash ``wgmma`` at
               d=96, run at its 128-wide instance) and mamba2-130m with a
               state of 512 (the SSD split across blocks in two slices),
               each with phase 2's checks at its widths, held to phase 3's
               rules, its kernel timed at the serve's own shape and its
               prefill timed;
  5. train   — (a) one round of smoke fedsllm-100m (fp32) on the card and on
               the CPU from the same state and batches, agreeing within 1e-4;
               (b) three rounds of full-width, full-depth fedsllm-100m (bf16,
               K=4 clients of 8 x 256 tokens, I_loc=11, weighted FedAvg, one
               client masked out of the second round) through
               ``build_round_fn``, with finite metrics, no effect of the
               masked client's batch, split == monolithic and bf16 against
               fp32 within the limits of ``TRAIN_LIMITS``, which must reject
               wrong updates (h̄ scaled by 0.5, a client left out), and no
               kernel launch in the phase (training runs no kernel: they are
               forward-only); round
               seconds, ms per split forward/backward, peak memory and the
               device's busy share and top operations of one pass;
  6. priced  — the round priced as the paper's §IV does and run two-tier:
               (a) on the host, K=4 clients of ``geo-blockfade``'s seed-0
               network attached to the ``edge-agg`` graph (2 edges) and,
               for comparison, the ``star``: ``localize`` → ``allocate``
               (``proposed`` with ``eta_search="coarse"``, ``EB``, ``FE``,
               ``BA``) → ``round_timing`` (``HierRoundTiming``), checked
               feasible, within each cell's bandwidth budget (Lemma 3), with
               ``proposed`` no slower than the others and every time finite;
               (b) on the card, from phase 5's last state and batches, one
               two-tier round at the training η = min(η*, eta_train_max)
               with the attachment one-hot (``build_round_fn(...,
               two_tier=True)``), held against the flat round (the two-tier
               ḡ of the same round-start gradients within 2^-8, the same
               round in fp32 within 2^-8, the bf16 round's adapters within
               ``PRICED_LIMITS``, which must reject a wrong cross-edge
               weighting, beside the flat round with its clients
               reordered), the masked client's batch without
               effect, a ``median`` two-tier round finite, and no kernel
               launch in the phase; round seconds, ms per pass, peak memory;
  7. campaign — the ``Experiment`` facade on full-width fedsllm-100m (bf16,
               K=4, cohort 4, 8 x 256 tokens): (a) a 3-round campaign of
               ``Experiment.from_config(..., scenario="blockfade",
               topology="star", eta_search="warm")`` with per-round channel
               re-sampling and joint re-allocation, a deadline that masks
               round 0's slowest client and a checkpoint each round; a fresh
               experiment resumes from round 2 and must end on the
               uninterrupted run's state bit for bit, both under
               ``torch.use_deterministic_algorithms(True)``; (b) at most one
               round function per η bucket; (c) a round with the int8 uplink
               codec (its uplink bits 8 per element + 32) and one with DP
               (clip 1, noise 0.5: every client's clipped update within the
               clip); (d) a smoke round of the facade on the card within 1e-4
               of the CPU's; (e) no kernel launch in the phase. Prints
               simulated T, η and the mask per round, device round seconds,
               host seconds outside the round function and peak memory;
  8. cli     — the entry points a user runs, and the variants they need:
               (a) the fp32 LoRA and flash variants, bf16 LoRA at ranks other
               than 16 (``prefill`` and ``decode`` at ranks 4, 80, 100, 128,
               256 and 512 up to mistral-7b's w_gate) and at the shapes a
               tensor map cannot read (x one element off 16 bytes, K or N %
               8 != 0: ``prefill`` and ``decode`` with the producers'
               copied tiles); fp32 LoRA at fedsllm-100m's shapes, ranks 80 and
               128, and gemma2-9b's M=2 decode shapes) against their plain
               versions at full width, TF32 off (limits ``CLI_LIMITS``),
               with event, device, plain, library and bound times (fp32
               operations at ``PEAK_FP32``, three TF32 products' rate) and
               each row's floor,
               target and bound share (``judge``);
               (b) ``launch.serve.main(["--smoke"])``
               for both archs, every launch on the fp32 variants (SSD on
               ``tf32``) by the per-variant counters, plus ``--lora-rank 80``
               in fp32 and ``--lora-rank 80``, ``100`` and ``4`` in bf16
               (``prefill`` and ``decode`` only), and the fp32 model's
               logits through the kernels within 1e-4 of the plain path's;
               the kernels timed at those shapes; (c) ``launch.train.main``
               on full-width fedsllm-100m (bf16, AdamW, 20 steps of 8 x 256,
               a checkpoint every 10): finite, falling loss, a second run
               resumed from step 10 ending on the same params and optimizer
               state bit for bit (deterministic algorithms), a microbatch-2
               step against the full batch, no kernel launch; ms per step,
               peak memory, busy share and top operations; (d) the
               ``--fedsllm`` trainer (4 clients, 2 rounds, ``EB``) at full
               width, its simulated times equal to the same command's with
               ``--smoke --device cpu`` on the host; (e)
               ``pipelined_split_grads`` (M = 4) at full width against the
               full-batch split step; (f) ``repro_torch.examples.quickstart``
               and ``serve_demo`` on the card, their prefills on the fp32
               flash variant (and SSD ``tf32``). Written to
               ``build/chip_smoke/cli.json``;
  9. dense   — the rest of the dense family: (a) flash attention at
               gemma2-9b's prefill (B=2, H=16, Kv=8, S=8192, head dim 256;
               global and windowed 4096, with and without its softcap 50,
               and a ragged S=300) in bf16 (``wgmma``) and fp32, and once
               with q misaligned for TMA (bf16 ``wgmma``, q's tiles copied
               by the producer warps), against the
               plain version, with event, device, plain, SDPA and bound
               times, and the LoRA kernel at every (M, K, N, r) that the
               serves below launch, on the variant its rule picks, against
               its plain version with its launches there and its times,
               and the decode variant at each of those decode shapes with
               every cluster split of K (1-8 blocks), held and timed;
               (b) gemma2-9b at full width and depth (42 layers, bf16)
               served through ``decode_tokens`` (B=2, prompt 8192, 32 new
               tokens; every launch counted by variant, 21 of the 42 flash
               calls windowed, the L caches 4096 slots that wrap), its
               greedy tokens against the plain path's, each of its 21
               groups' update through the kernels no further from fp32
               than twice the plain path's (from the same input), and at 4
               layers
               phase 3's logits rule, the ring-buffer decode against the
               fp32 forward over the longer sequence and the fp32 model
               served through the fp32 variants; (c) phi4-mini-3.8b and
               starcoder2-7b (full depth) and command-r-35b (8 of 40 layers)
               served at B=8, prompt 512, 32 new tokens, launches by
               variant (every bf16 LoRA launch on ``prefill`` or
               ``decode``, starcoder2's and command-r's large-K down
               projections included; every flash launch on ``wgmma``),
               the rule, and flash at head dim 128; (d) a FedsLLM round of
               full phi4-mini-3.8b and a split pass of full gemma2-9b
               (remat) against monolithic, no kernel launch; (e) the four
               smoke configs on the card against the CPU and through
               ``launch.serve --smoke``. Written to
               ``build/chip_smoke/dense.json``;
 10. families — the MoE and hybrid families: (a)-(c) olmoe-1b-7b (16
               layers) and qwen3-moe-235b-a22b (3 of 94 layers) served at
               B=8, prompt 512, 32 new tokens, recurrentgemma-9b (38
               layers) at B=2, prompt 4096 (twice its window) through
               ``decode_tokens``, launches by variant, each with the
               logits rule against its fp32 copy at the served depth, the
               MoE layers' routing flips (kernel vs plain vs fp32, per
               layer) and dispatch pairs dropped, greedy tokens equal but
               for ties and rows whose routing flipped upstream, and the
               ring decode against the fp32 forward; (d) flash at each
               serve's shape (group sizes 1 and 16, MQA at d=256 with
               window 2048) and every LoRA shape the serves launch against
               their plain versions with their times, and the decode split
               sweep at their decode shapes; (e) a split pass of each
               family's smoke config on the card against the CPU and a
               full-width olmoe split pass. Written to
               ``build/chip_smoke/families.json``;
 11. encdec_vlm — the encoder-decoder and vision-language families:
               (a) whisper-base (6 + 6 layers) served at B=8 clips of 1,500
               seeded frame embeddings with a 32-token prompt and, F4's
               case, a one-token prompt; (b) llava-next-mistral-7b (32
               layers) at B=2, 2,880 seeded patch embeddings and a
               1,216-token prompt (4,096 positions); each through
               ``decode_tokens`` with 32 new tokens, launches by variant
               (the encoder's and the cross-attention's flash calls
               non-causal), the logits rule against fp32, greedy tokens
               equal but for ties, and the fp32 decode step (cross keys
               from the cache, at position Tv + S) against the fp32
               forward over the appended sequence; (c) the smoke configs'
               split pass and kernel forward on the card against the CPU,
               and a full-width whisper split pass against monolithic and
               the merged loss; (d) flash at the serves' four attention
               shapes (whisper's encoder, self and cross, llava's) and
               every LoRA shape they launch, against their plain versions,
               with their times. Written to ``build/chip_smoke/encdec_vlm.json``;
 12. dryrun — ``launch/dryrun.py`` on four cells: gemma2-9b x
               prefill_32k (flash ``wgmma`` d=256 with softcap, global and
               windowed, at 32,768; the ring cache; LoRA ``prefill`` at M =
               b x 32,768), llava-next-mistral-7b x decode_32k (LoRA; plain
               decode attention over a 32k cache), whisper-base x train_4k
               (the plain training path: no launch) and recurrentgemma-9b x
               long_500k (a decode step at position 524,287): each planned
               on the meta device and measured by ``measure_cell`` (M1, M2,
               M1t; composed and scaled to the global batch), every run's
               launches by variant held (LoRA ``prefill``/``decode``, flash
               ``wgmma``, nothing else) and its resident bytes equal to the
               meta plan's; the check cells whisper-base x prefill_32k and
               mamba2-130m x train_4k at b=4, composed from M1/M2 and
               measured at full depth, within ``DRYRUN_LIMITS``; flash and
               LoRA at gemma2-9b's 32k shapes against their plain versions
               (flash in fp32 query chunks, each query row within 2 bf16
               ulps of its own largest output; a window moved by one 64-key
               tile must fail that check).
               Written to ``build/chip_smoke/dryrun.json``.

Prints the compiled kernels' registers and spills, the card's name and power
limit, a ``{"kernels": [...]}`` line (the three kernels on the bf16 serving
paths, then each variant of the fp32 serve path of phase 8, the bf16
LoRA variants at ranks other than 16 and with copied tiles (prefill, decode)
and phase 8 (a)'s redesigned rows (``next_entries``), then phase 9's
flash variants at head dims 256 and 128 and the LoRA kernel on each of its
serves, then phase 10's and phase 11's LoRA kernel and flash on each of
their serves, then phase 12's 32k rows), and last
``{"ok": true, "device": {...}}``. Details go to ``build/chip_smoke/``.
Without a CUDA card it exits non-zero before printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS is deterministic only with a fixed workspace, which must be set before
# CUDA starts (phase 7 runs under torch.use_deterministic_algorithms)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import Experiment  # noqa: E402
from repro_torch.api.aggregators import get_aggregator  # noqa: E402
from repro_torch.api.allocators import get_allocator  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.config import (SHAPES, FedsLLMConfig, LoRAConfig, RunConfig,  # noqa: E402
                                TrainConfig, get_arch, smoke_variant)
from repro_torch.core import federated, fedsllm, privacy, split  # noqa: E402
from repro_torch.core.delay_model import sample_network  # noqa: E402
from repro_torch.core.lora import init_lora, merge, split_client_server  # noqa: E402
from repro_torch.data.tokens import TokenStream, client_batches  # noqa: E402
from repro_torch.examples import quickstart, serve_demo  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as flash_binding  # noqa: E402
from repro_torch.kernels import lora_matmul as lora_binding  # noqa: E402
from repro_torch.kernels.attn_ops import flash_attention  # noqa: E402
from repro_torch.kernels.attn_ref import flash_attention_fp32, flash_attention_ref  # noqa: E402
from repro_torch.kernels.lora_ops import lora_matmul  # noqa: E402
from repro_torch.kernels.lora_ref import lora_matmul_ref  # noqa: E402
from repro_torch.kernels.ssd_ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.registry import active_param_count, count_params  # noqa: E402
from repro_torch.launch import dryrun, serve, steps, train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.net.topology import get_topology  # noqa: E402
from repro_torch.parallel.pipeline import pipelined_split_grads  # noqa: E402
from repro_torch.serving.decode import decode_tokens  # noqa: E402
from repro_torch.sim import events  # noqa: E402
from repro_torch.sim.scenario import get_scenario  # noqa: E402
from repro_torch.tree import (tree_index, tree_leaves, tree_map, tree_rel_gap,  # noqa: E402
                              tree_stack)

OUT = ROOT / "build" / "chip_smoke"
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 bandwidth
# (the dry-run's), dense TF32 on the tensor cores. fp32 work is bound at the
# card's fastest rate that holds an fp32 result: three TF32 products (each
# operand's big and small TF32 terms: big·big + big·small + small·big) at the
# TF32 rate, 165 TFLOP/s, above the CUDA cores' 67. Every fp32 row counts its
# function's operations at that rate, whatever units its kernel runs them on.
PEAK_BF16, HBM_BYTES_PER_S = dryrun.PEAK_BF16, dryrun.HBM_BYTES_PER_S
PEAK_TF32 = 495e12
PEAK_FP32 = PEAK_TF32 / 3
BATCH, PROMPT, NEW = 8, 512, 32
ADAPTER_B_STD = 0.05  # std of the non-zero B drawn for the adapters
ARCHS = ("fedsllm-100m", "mamba2-130m")
KERNELS = {"lora_matmul": lora_matmul, "flash_attention": flash_attention, "ssd_scan": ssd_scan}
# per-variant launch counters of the kernels that have variants
VARIANTS = {"lora_matmul": lora_matmul.variant_launches,
            "flash_attention": flash_attention.variant_launches,
            "ssd_scan": ssd_scan.variant_launches}
# µs per launch of the first port's kernels, before their Hopper redesign
# (this script on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6), keyed by
# kernel and, for LoRA, (dtype, M, K, N, r). bf16 rank 16: event times
# before the prefill and decode redesign; bf16 ranks above 64 and not a
# multiple of 8: the generic variant's CUDA-graph device times before they
# took prefill and decode (``compare_kernels.py`` against the checkout
# before each change; r=100 at prefill: this script's phase 8 (a) on that
# checkout); fp32: the first fp32 SIMT tile's CUDA-graph device times
# before its Hopper redesign (this script's phase 8 (a) on the checkout
# before it; gemma2-9b's M=2 shapes: ``compare_kernels.py`` against it);
# bf16 shapes a tensor map cannot read (x misaligned, K or N % 8 != 0) and
# fp32 flash: the generic variant's and the SIMT fp32 flash kernel's
# CUDA-graph device times before their Hopper designs (``compare_kernels.py``
# against the checkout before the change, NVIDIA H100 80GB HBM3, 700 W)
EARLIER_US = {
    **{("lora_matmul", "bfloat16", *k): v for k, v in {
        (4096, 768, 768, 16): 93.3, (4096, 768, 256, 16): 74.5, (4096, 768, 2048, 16): 221.2,
        (4096, 2048, 768, 16): 218.4, (8, 768, 768, 16): 63.8, (8, 768, 256, 16): 62.9,
        (8, 768, 2048, 16): 63.5, (8, 2048, 768, 16): 160.3, (4096, 768, 3352, 16): 325.3,
        (4096, 1536, 768, 16): 169.3, (8, 768, 3352, 16): 63.6, (8, 1536, 768, 16): 122.1,
        (4096, 768, 2048, 128): 923.3, (4096, 768, 2048, 256): 1648.0,
        (4096, 4096, 14336, 128): 31146.7, (8, 768, 768, 128): 147.8, (8, 768, 768, 256): 262.5,
        (8, 4096, 14336, 128): 671.9, (4096, 768, 2048, 100): 982.7, (8, 768, 768, 100): 146.6,
        (4096, 768, 2048, 4): 479.1, (8, 768, 768, 4): 65.6, (4096, 768, 2048, 512): 3100.4,
        (8, 768, 768, 512): 484.9,
        }.items()},
    **{("lora_matmul", "float32", *k): v for k, v in {
        (8, 768, 768, 16): 90.1, (8, 768, 2048, 16): 89.8, (8, 2048, 768, 16): 231.3,
        (4096, 768, 2048, 16): 371.1, (4096, 2048, 768, 16): 478.6, (4096, 768, 256, 16): 93.7,
        (4096, 768, 2048, 80): 705.8, (4096, 768, 2048, 128): 721.0, (8, 768, 768, 80): 173.2,
        (8, 768, 768, 128): 178.4, (4096, 768, 768, 16): 187.5, (8, 768, 256, 16): 88.7,
        (2, 3584, 14336, 16): 404.2, (2, 14336, 3584, 16): 1595.7,
        }.items()},
    **{("lora_matmul", "bfloat16", *k): v for k, v in {
        (4096, 768, 2048, 16, "misaligned"): 527.8, (8, 768, 768, 16, "misaligned"): 66.3,
        (8, 772, 768, 16): 67.1, (4096, 772, 768, 16): 217.0, (8, 768, 300, 16): 51.9,
        (4096, 768, 300, 16): 142.9,
        }.items()},
    **{("flash_attention", "float32", *k): v for k, v in {
        (8, 512, 12, 4, 64, 0, 0.0): 210.1, (8, 512, 12, 4, 64, 0, 50.0): 231.5,
        (8, 512, 12, 4, 64, 128, 0.0): 100.8, (2, 512, 8, 2, 128, 0, 0.0): 140.4,
        (2, 8192, 16, 8, 256, 0, 50.0): 58314.0, (2, 8192, 16, 8, 256, 4096, 50.0): 42445.0,
        (4, 32, 4, 2, 16, 0, 0.0): 3.63,
        }.items()},
    ("flash_attention",): 140.2, ("ssd_scan",): 485.1,
}
DECODE_TARGET_MS = 0.010  # the decode LoRA's device-time target per launch


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: float, peak: float = PEAK_BF16) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bf16_ulps(ref, n: float = 2.0) -> float:
    """n bf16 ulps (2^-7 relative) of the largest output."""
    return n * 2.0 ** -7 * ref.float().abs().max().item()


TRACES = 2  # torch.profiler traces taken before a lossy one is given up
TRACE_LOG = collections.Counter()  # traces kept / lost, for the summary
TRACE_PAD_S = 0.1  # idle host time at each end of a trace's window
MARK_CYCLES = 20_000  # a marker kernel's spin, ~10 µs


def is_marker(key: str) -> bool:
    return "spin_kernel" in key


def trace(fn):
    """The CUDA kernel and host op records of one torch.profiler trace of fn().
    The profiler drops kernels at the ends of a trace's window (a trace of
    one call often holds none of its kernels): the idle pad at each end
    keeps a small offset between the host's and the device's clocks from
    dropping them, and a marker kernel (``torch.cuda._sleep``'s
    ``spin_kernel``) before and after fn() takes the ends' place; the
    markers' records are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        torch.cuda._sleep(MARK_CYCLES)
        fn()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    events = [e for e in prof.key_averages() if not is_marker(e.key)]
    return ([e for e in events if e.device_type == DeviceType.CUDA],
            [e for e in events if e.device_type == DeviceType.CPU])


def port_launches() -> int:
    return sum(fn.launches for fn in KERNELS.values())


def name_counts(kernels) -> dict:
    """Records per kernel name of a trace."""
    return {e.key: e.count for e in kernels}


def device_ms(fn) -> tuple[float | None, list, list]:
    """Device time of the CUDA kernels one call of fn runs (torch.profiler),
    the kernels that take most of it, and the host ops that take most host
    time. Traces of one call each are taken until one records, name by
    name, as many kernels as an earlier one did (and no fewer than the
    port's kernels launched in it, by their counters): a trace that lost
    records of any kernel, the port's, a plain path's or a library's, differs
    from a whole one. After TRACES + 1 traces without two that agree the
    device time is None (not measured)."""
    seen = []
    for _ in range(TRACES + 1):
        before = port_launches()
        kernels, host = trace(fn)
        launched = port_launches() - before
        counts = name_counts(kernels)
        recorded = sum(counts.values())
        if kernels and recorded >= launched and counts in seen:
            TRACE_LOG["kept"] += 1
            kernels.sort(key=lambda e: -e.self_device_time_total)
            host.sort(key=lambda e: -e.self_cpu_time_total)
            total = sum(e.self_device_time_total for e in kernels) / 1e3
            return (total,
                    [(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in kernels[:10]],
                    [(e.key[:90], e.self_cpu_time_total / 1e3, e.count) for e in host[:10]])
        if seen:
            TRACE_LOG["lost"] += 1
            log(f"[timing] torch.profiler recorded {recorded} kernels over {len(counts)} names "
                f"(the port launched {launched}), unlike the earlier traces "
                f"{[sum(c.values()) for c in seen]}: a lossy trace")
        seen.append(counts)
    return None, [], []


def graph_ms(fn, arg_sets, iters: int = 30) -> float:
    """Mean device time per call of fn(*args): `iters` calls cycling through
    `arg_sets` captured into one CUDA graph and replayed between two CUDA
    events. Free of the host's launch cost, as the profiler's time is, and
    independent of the profiler; it includes the graph's gaps between kernels."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    graph.reset()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, arg_sets, iters: int = 30, bound: float | None = None) -> dict:
    """Mean device time per call of fn(*args), two ways: ``graph_ms`` (CUDA
    graph replay, always taken) and the CUDA kernels' time in a torch.profiler
    trace of `iters` calls cycling through `arg_sets`. A trace of one call
    gives each kernel name's records per call; a trace of the `iters` calls
    is kept only when every name has `iters` times that many records, and
    no other name has any (a library call may launch several kernels under
    one name, so the most recorded name alone cannot tell a lossy trace). A
    lossy trace is taken again, and after TRACES lossy traces
    ``device_ms`` is the graph's time. A kept time below ``bound`` (the
    least time the card could take: faster than its peak rate or its memory
    allow) is refused as well, and the graph's time is taken: the log says
    so. ``device_ms_by`` says which time ``device_ms`` is."""
    out = {"graph_ms": graph_ms(fn, arg_sets, iters)}
    per_call = name_counts(trace(lambda: fn(*arg_sets[0]))[0])
    want = {name: n * iters for name, n in per_call.items()}
    for _ in range(TRACES):
        kernels, _ = trace(lambda: [fn(*arg_sets[i % len(arg_sets)]) for i in range(iters)])
        got = name_counts(kernels)
        if kernels and got == want:
            TRACE_LOG["kept"] += 1
            total = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
            if bound is not None and total < bound:
                TRACE_LOG["above_peak"] += 1
                log(f"[timing] torch.profiler's {total:.5f} ms a call is below the bound "
                    f"{bound:.5f} ms (above the card's peak): the CUDA graph's "
                    f"{out['graph_ms']:.5f} ms is taken")
                return {"device_ms": out["graph_ms"], "device_ms_by": "cuda_graph_above_peak",
                        **out}
            return {"device_ms": total, "device_ms_by": "profiler", **out}
        TRACE_LOG["lost"] += 1
        short = {name: f"{got.get(name, 0)}/{n}" for name, n in want.items()
                 if got.get(name, 0) != n}
        log(f"[timing] torch.profiler recorded {sum(got.values())} of {sum(want.values())} "
            f"kernels for {iters} calls ({len(short)} of {len(want)} names short, "
            f"{len(set(got) - set(want))} unexpected): a lossy trace")
    return {"device_ms": out["graph_ms"], "device_ms_by": "cuda_graph", **out}


def share(part: float | None, whole: float) -> float | None:
    return None if part is None else part / whole


def library(times: dict | None) -> dict:
    """A library call's device times (from device_time_ms) under the row's
    ``library_`` keys, all None where no library call computes the function."""
    keys = ("device_ms", "device_ms_by", "graph_ms")
    return {f"library_{k}": None if times is None else times[k] for k in keys}


def judge(row: dict) -> dict:
    """The row's verdicts: floor (event time at most half its earlier time;
    and the same for the device time, which the host's launch cost does not
    hide), target (device time no slower than
    the library call's, or at most 10 µs at a bf16 decode shape whose bound
    is below 5 µs, and both at such an fp32 one), and its device time's share
    of the bound."""
    if row["kernel"] == "lora_matmul":  # (a misaligned row's are the copied shapes')
        key = (row["kernel"], row["dtype"], row["M"], row["K"], row["N"], row["r"],
               *(("misaligned",) if row.get("misaligned") else ()))
    elif row.get("dtype") == "float32":
        key = tuple(row[k] for k in ("kernel", "dtype", "B", "S", "H", "Kv", "d", "window",
                                     "softcap"))
    else:
        key = (row["kernel"],)
    earlier = EARLIER_US.get(key)
    row["earlier_ms"] = earlier / 1e3 if earlier else None
    row["floor_met"] = None if earlier is None else row["ms"] <= earlier / 2e3
    row["floor_met_device"] = None if earlier is None else row["device_ms"] <= earlier / 2e3
    row["bound_share"] = row["bound_ms"] / row["device_ms"]
    fp32_decode = (row["kernel"] == "lora_matmul" and row.get("variant") == "fp32"
                   and row["M"] <= lora_binding.DECODE_MAX_M)
    if row.get("variant") == "decode" and row["bound_ms"] < DECODE_TARGET_MS / 2:
        row["target"], row["target_met"] = "device_ms <= 0.010", row["device_ms"] <= DECODE_TARGET_MS
    elif fp32_decode and row["bound_ms"] < DECODE_TARGET_MS / 2:
        row["target"] = "device_ms <= library_device_ms and device_ms <= 0.010"
        row["target_met"] = row["device_ms"] <= min(row["library_device_ms"], DECODE_TARGET_MS)
    elif row.get("library_device_ms") is not None:
        row["target"] = "device_ms <= library_device_ms"
        row["target_met"] = row["device_ms"] <= row["library_device_ms"]
    else:
        row["target"], row["target_met"] = None, None
    return row


def ran_variant(name: str, fn) -> str:
    """The one variant of kernel `name` that a call of fn launches."""
    before = dict(VARIANTS[name])
    fn()
    moved = [k for k, v in VARIANTS[name].items() if v != before[k]]
    assert len(moved) == 1, moved
    return moved[0]


def host_ms(fn, arg_sets, iters: int = 200) -> float:
    """Host time per call of fn(*args) (perf_counter, no synchronisation in
    the loop): the cost of a launch through the wrapper, which bounds the
    event-timed ``ms`` from below."""
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return t


def time_ms(fn, arg_sets, iters: int) -> float:
    """Mean device time of fn(*args) over `iters` back-to-back calls, cycling
    through `arg_sets` (distinct buffers: > 50 MB in all, so the card's L2
    cannot hold a call's inputs from the last time it saw them)."""
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def n_sets(bytes_per_set: int) -> int:
    return max(2, math.ceil(120e6 / bytes_per_set))


# ---------------------------------------------------------------------------
# shapes of the serving path
# ---------------------------------------------------------------------------


def lora_shapes(cfg, ch: str | None = None) -> collections.Counter:
    """(K, N) of each adapted 2-D projection of one layer of char ``ch`` (the
    pattern's first by default), with its count: an MoE layer's stacked
    expert products are einsums, not LoRA launches."""
    D, F = cfg.d_model, cfg.d_ff
    ch = ch or cfg.layer_pattern[0]
    if ch == "M":  # in_proj, out_proj
        d_inner, H, P, N, conv_ch = M2.dims(cfg)
        return collections.Counter([(D, 2 * d_inner + 2 * N + H), (d_inner, D)])
    mlp = [(D, F)] * (1 if cfg.mlp_activation == "gelu" else 2) + [(F, D)]  # gelu: no gate
    if ch == "R":  # w_rec_in, w_gate_in, w_out
        W = cfg.lru_width
        return collections.Counter([(D, W), (D, W), (W, D)] + mlp)
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return collections.Counter([(D, q), (D, kv), (D, kv), (q, D)]
                               + ([] if cfg.num_experts else mlp))


def model_lora_shapes(cfg) -> collections.Counter:
    """(K, N) of each adapted projection of one forward, over every layer."""
    out = collections.Counter()
    for ch in cfg.pattern:
        out.update(lora_shapes(cfg, ch))
    return out


def path_variants(cfg) -> dict[str, dict[str, int]]:
    """Launches of each variant in one decode_tokens call: the prefill's LoRA
    products (M = B·S) through the prefill variant, the decode steps' (M = B)
    through the decode variant, flash and the SSD scan (one per layer of the
    prefill) through their wgmma variants."""
    per_forward = sum(lora_shapes(cfg).values()) * cfg.num_layers
    ssm = cfg.layer_pattern == "M"
    return {"lora_matmul": {"prefill": per_forward, "decode": per_forward * (NEW - 1),
                            "fp32": 0},
            "flash_attention": {"wgmma": 0 if ssm else cfg.num_layers, "fp32": 0},
            "ssd_scan": {"wgmma": cfg.num_layers if ssm else 0, "tf32": 0}}


def path_kernels(cfg) -> dict[str, int]:
    """Launches of each kernel in one decode_tokens call (prefill + NEW-1 steps)."""
    per_forward = sum(lora_shapes(cfg).values()) * cfg.num_layers
    ssm = cfg.layer_pattern == "M"
    return {"lora_matmul": per_forward * NEW,
            "flash_attention": 0 if ssm else cfg.num_layers,  # one per layer of the prefill
            "ssd_scan": cfg.num_layers if ssm else 0}


def lora_inputs(gen, M, K, N, r, dev, dtype=torch.bfloat16):
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    w, a, b = (torch.randn(s, generator=gen, device=dev).mul(0.05).to(dtype)
               for s in ((K, N), (K, r), (r, N)))
    return x, w, a, b


def lora_work(M, K, N, r, esize=2):
    nbytes = esize * (M * K + K * N + K * r + r * N + M * N)
    ops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N
    return nbytes, ops


def lora_bound(M, K, N, r, dtype) -> tuple[float, str]:
    """The least time of one LoRA call: its bytes at HBM's rate, or its
    operations at the card's peak for their type (bf16: the tensor cores';
    fp32: ``PEAK_FP32``)."""
    fp32 = dtype == torch.float32
    return bound_ms(*lora_work(M, K, N, r, 4 if fp32 else 2), PEAK_FP32 if fp32 else PEAK_BF16)


def shifted(t):
    """t's values in a view one element off a 16-byte boundary (no tensor
    map reads it)."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view_as(t).copy_(t)


def attn_inputs(gen, B, S, H, Kv, d, dev, dtype=torch.bfloat16, misaligned=False, Skv=None):
    """q, k, v in the model's (B, S, heads, d) layout, as (B, heads, S, d)
    views (k and v of ``Skv`` positions, S by default); ``misaligned``: q
    (True) or the operands it names ("kv") one element off a 16-byte
    boundary (TMA cannot read them)."""
    names = "q" if misaligned is True else misaligned or ""
    q = torch.randn((B, S, H, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, Skv or S, Kv, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    return tuple((shifted(t) if name in names else t).transpose(1, 2)
                 for name, t in zip("qkv", (q, k, v)))


def attn_work(B, S, H, Kv, d, causal, window, esize=2, Skv=None):
    Skv = Skv or S
    qpos = torch.arange(S)[:, None]
    kpos = torch.arange(Skv)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    pairs = int(mask.sum())  # score entries this input needs
    nbytes = esize * (2 * B * H * S * d + 2 * B * Kv * Skv * d)
    ops = 4 * B * H * pairs * d  # Q·Kᵀ and P·V
    return nbytes, ops


def ssd_inputs(gen, B, S, H, P, N, dev, dtype=torch.float32, h0=False):
    """Drawn as tests/test_kernels.py draws the reference's SSD cases."""
    x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.3)
    Bm = (torch.randn((B, S, N), generator=gen, device=dev) * 0.5).to(dtype)
    Cm = (torch.randn((B, S, N), generator=gen, device=dev) * 0.5).to(dtype)
    state = torch.randn((B, H, P, N), generator=gen, device=dev) if h0 else None
    return x, dt, A, Bm, Cm, state


def ssd_chunk_ops(B, S, H, P, N, Q):
    """Operations of the chunked algorithm at chunks of Q steps: scores C·Bᵀ
    and their product with dt·x, 2·Q²·(N+P) per chunk; the state's
    contribution and update, 4·Q·N·P; per (b, h). At Q = 64 it is what the
    wgmma and tf32 variants do."""
    Q = min(Q, S)
    return B * H * math.ceil(S / Q) * (2 * Q * Q * (N + P) + 4 * Q * N * P)


def ssd_work(B, S, H, P, N, esize, h0):
    """Bytes: x, dt, A, Bm, Cm read once, y (fp32) and the final state written
    once, the initial state read once if given. Operations: the least any
    chunk needs, ``ssd_chunk_ops`` at Q = 1 (the sequential recurrence,
    4·N·P a step, and the step's own C·B times dt·x, 2·(N+P)): the result
    does not depend on the chunk and the count falls with Q, so the bound
    reads the function's work whatever variant runs (at mamba2-130m's widths
    the 64-step chunk counts 1.7x as many, the reference's 256 4x)."""
    nbytes = (esize * (B * S * H * P + 2 * B * S * N) + 4 * (B * S * H + H)
              + 4 * B * S * H * P + 4 * B * H * P * N * (2 if h0 else 1))
    return nbytes, ssd_chunk_ops(B, S, H, P, N, 1)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def ptxas_summary(text: str) -> list[dict]:
    """Registers, spills and static shared memory of each compiled kernel,
    from ``nvcc -Xptxas -v`` output; names demangled by ``c++filt``."""
    rows, name = [], None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            rows.append({"kernel": name, "spill_stores": int(m.group(1)),
                         "spill_loads": int(m.group(2))})
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1].update(registers=int(m.group(1)), static_smem=int(smem.group(1)) if smem else 0)
            name = None
    if shutil.which("c++filt"):  # else the mangled names stay
        names = subprocess.run(["c++filt"], input="\n".join(r["kernel"] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        for r, demangled in zip(rows, names):
            r["kernel"] = re.sub(r"\(anonymous namespace\)::|\(.*|^void ", "", demangled)
    return rows


def phase_build() -> dict:
    t0 = time.perf_counter()
    logs = _build.build()
    seconds = time.perf_counter() - t0
    (OUT / "build_log.txt").write_text("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    log(f"[build] {len(logs)} kernel(s) compiled in {seconds:.1f} s "
        f"into {_build.BUILD_DIR.relative_to(ROOT)} (ptxas output: {(OUT / 'build_log.txt').relative_to(ROOT)})")
    ptxas = [dict(library=name, **row) for name, text in logs.items()
             for row in ptxas_summary(text)]
    for row in ptxas:
        log(f"[build] {json.dumps(row)}")
    return {"seconds": seconds, "ptxas": ptxas}


def phase_kernels(cfg, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    lcfg = cfg.lora or LoRAConfig()  # the adapters' config (the default where a config has none)
    r = lcfg.rank
    fails, rows = [], []
    errs = {"lora_matmul": 0.0}
    for M in (8, 37, BATCH * PROMPT):
        for K, N in lora_shapes(cfg):
            x, w, a, b = lora_inputs(gen, M, K, N, r, dev)
            y = lora_matmul(x, w, a, b, scale=lcfg.scale)
            torch.cuda.synchronize()
            ref = lora_matmul_ref(x, w, a, b, scale=lcfg.scale)
            err = (y.float() - ref.float()).abs().max().item()
            # both round the same fp32 sums, accumulated in another order
            tol = bf16_ulps(ref)
            rows.append(dict(kernel="lora_matmul", M=M, K=K, N=N, r=r, err=err, tol=tol))
            errs["lora_matmul"] = max(errs["lora_matmul"], err)
            if not err <= tol:
                fails.append(rows[-1])
    # the fp32 variant at the path's widths, and a rank above 64 (bf16: decode
    # and prefill, in two launches)
    errs["lora_matmul/fp32"] = 0.0
    cases = [(M, K, N, r, torch.float32, "fp32") for M in (8, BATCH * PROMPT)
             for K, N in lora_shapes(cfg)]
    K, N = next(iter(lora_shapes(cfg)))
    cases += [(M, K, N, 80, torch.bfloat16, "decode" if M <= 16 else "prefill")
              for M in (8, BATCH * PROMPT)]
    for M, K, N, rank, dtype, expected in cases:
        x, w, a, b = lora_inputs(gen, M, K, N, rank, dev, dtype)
        kind = ran_variant("lora_matmul", lambda: lora_matmul(x, w, a, b, scale=lcfg.scale))
        y = lora_matmul(x, w, a, b, scale=lcfg.scale)
        torch.cuda.synchronize()
        ref = lora_matmul_ref(x, w, a, b, scale=lcfg.scale)
        err = (y.float() - ref.float()).abs().max().item()
        fp32 = dtype == torch.float32
        tol = CLI_LIMITS["lora_fp32"] * ref.abs().max().item() if fp32 else bf16_ulps(ref)
        rows.append(dict(kernel="lora_matmul", M=M, K=K, N=N, r=rank,
                         dtype=str(dtype).split(".")[-1], variant=kind, err=err, tol=tol))
        if fp32:
            errs["lora_matmul/fp32"] = max(errs["lora_matmul/fp32"], err)
        if not err <= tol or kind != expected:
            fails.append(rows[-1])
    if cfg.layer_pattern == "M":
        fails += ssd_checks(cfg, dev, gen, rows, errs)
    else:
        fails += flash_checks(cfg, dev, gen, rows, errs)
    for row in rows:
        log(f"[kernels] {json.dumps(row)}")
    if fails:
        raise SystemExit(f"[kernels] {len(fails)} case(s) disagree with the plain version: {fails}")
    return {"max_abs_err": errs, "cases": rows}


def flash_checks(cfg, dev, gen, rows, errs) -> list:
    fails = []
    errs["flash_attention"] = 0.0
    H, Kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for S, window, softcap in ((PROMPT, 0, 0.0), (200, 0, 0.0), (PROMPT, 128, 0.0),
                               (PROMPT, 0, 50.0)):
        q, k, v = attn_inputs(gen, BATCH, S, H, Kv, d, dev)
        o = flash_attention(q, k, v, causal=True, window=window, softcap=softcap)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=True, window=window, softcap=softcap)
        err = (o.float() - ref.float()).abs().max().item()
        # two bf16 ulps of the largest output: the kernel also rounds P to
        # bf16 for P·V (2^-9 relative per weight, below one output ulp)
        tol = bf16_ulps(ref)
        rows.append(dict(kernel="flash_attention", B=BATCH, S=S, H=H, Kv=Kv, d=d,
                         window=window, softcap=softcap, err=err, tol=tol))
        errs["flash_attention"] = max(errs["flash_attention"], err)
        if not err <= tol:
            fails.append(rows[-1])
    # the fp32 variant at the path's widths: 2e-5 + 2e-5·|o| per element
    errs["flash_attention/fp32"] = 0.0
    for window, softcap in ((0, 0.0), (128, 0.0), (0, 50.0)):
        q, k, v = attn_inputs(gen, BATCH, PROMPT, H, Kv, d, dev, torch.float32)
        call = lambda: flash_attention(q, k, v, causal=True, window=window,  # noqa: E731
                                       softcap=softcap)
        kind = ran_variant("flash_attention", call)
        o = call()
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=True, window=window, softcap=softcap)
        excess = ((o - ref).abs() - CLI_LIMITS["flash_fp32"] * ref.abs()).max().item()
        rows.append(dict(kernel="flash_attention", dtype="float32", B=BATCH, S=PROMPT, H=H,
                         Kv=Kv, d=d, window=window, softcap=softcap, variant=kind,
                         err=(o - ref).abs().max().item(), excess=excess,
                         tol=CLI_LIMITS["flash_fp32"]))
        errs["flash_attention/fp32"] = max(errs["flash_attention/fp32"], rows[-1]["err"])
        if not excess <= CLI_LIMITS["flash_fp32"] or kind != "fp32":
            fails.append(rows[-1])
    return fails


def ssd_checks(cfg, dev, gen, rows, errs) -> list:
    """y and the final state against the sequential recurrence, at the path's
    widths: the full prompt, a ragged S, an initial state, 8 reference
    chunks, in fp32 (the tf32 variant) and in bf16 (the wgmma variant), and
    the prefill's own bf16 strided views of the conv output. Tolerance 1e-4
    of the largest reference output, the reference's own
    (tests/test_kernels.py): tf32's products are 3xTF32 (each fp32 operand a
    TF32 big and small term), wgmma's take its fp32 operands (decayed scores,
    state, w·x) as two bf16 terms each; both sum in another order (and exp(cs_q − cs_s) stands for a product of
    per-step decays)."""
    fails = []
    errs["ssd_scan"] = 0.0
    _, H, P, N, _ = M2.dims(cfg)
    cases = [(S, h0, dtype, expected)
             for dtype, expected in ((torch.float32, "tf32"), (torch.bfloat16, "wgmma"))
             for S, h0 in ((PROMPT, False), (200, True), (PROMPT, True), (8 * cfg.ssm_chunk, False))]
    for S, h0, dtype, expected in cases + [(PROMPT, True, "views", "wgmma")]:
        if dtype == "views":
            x, dt, A, Bm, Cm, state = ssd_path_inputs(gen, cfg, dev)
        else:
            x, dt, A, Bm, Cm, state = ssd_inputs(gen, BATCH, S, H, P, N, dev, dtype, h0)
        kind = ran_variant("ssd_scan", lambda: ssd_scan(x, dt, A, Bm, Cm, initial_state=state))
        y, h = ssd_scan(x, dt, A, Bm, Cm, initial_state=state)
        torch.cuda.synchronize()
        yr, hr = ssd_scan_ref(x, dt, A, Bm, Cm, state)
        for out, ref, what in ((y, yr, "y"), (h, hr, "final_state")):
            err = (out - ref).abs().max().item()
            tol = 1e-4 * ref.abs().max().item()
            rows.append(dict(kernel="ssd_scan", variant=kind, out=what, B=BATCH, S=S, H=H, P=P,
                             N=N, initial_state=h0, dtype=str(dtype).split(".")[-1], err=err,
                             tol=tol))
            if kind != expected:
                rows[-1]["expected_variant"] = expected
            errs["ssd_scan"] = max(errs["ssd_scan"], err)
            if not err <= tol or kind != expected:
                fails.append(rows[-1])
    return fails


def make_model(cfg, dev, batch: int = BATCH, prompt_len: int = PROMPT):
    params = T.init_params(cfg, seed=0, device=dev)
    lora = init_lora(params, cfg, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    for ab in lora.values():  # B = 0 at init would hide the low-rank fold
        ab["B"] = (torch.randn(ab["B"].shape, generator=gen, device=dev)
                   * ADAPTER_B_STD).to(ab["B"].dtype)
    if cfg.layer_pattern == "M":
        # the reference's init makes A = -1, dt_bias = 0, D = 1, conv_b = 0 on
        # every head, which would hide a head-indexing fault: draw them per
        # head as Mamba-2 initialises them (A in [1, 16], dt in [1e-3, 1e-1])
        m = params["groups"]["sub_0"]["mamba"]
        u = lambda shape: torch.rand(shape, generator=gen, device=dev)
        m["A_log"] = torch.log(1 + 15 * u(m["A_log"].shape))
        dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) * u(m["dt_bias"].shape))
        m["dt_bias"] = dt + torch.log(-torch.expm1(-dt))  # softplus(dt_bias) = dt
        m["D_skip"] = 1 + 0.5 * torch.randn(m["D_skip"].shape, generator=gen, device=dev)
        m["conv_b"] = (0.1 * torch.randn(m["conv_b"].shape, generator=gen, device=dev)
                       ).to(m["conv_b"].dtype)
    for key, ch in enumerate(cfg.pattern[:len(cfg.layer_pattern)]):
        if ch == "R":
            # the reference's init makes every RG-LRU gate alike (w_a = b_a =
            # b_x = 0, w_x = lambda_p = 1), which would hide a channel-indexing
            # fault: draw them per channel, around that init
            rg = params["groups"][f"sub_{key}"]["rglru"]
            for name in ("w_a", "b_a", "w_x", "b_x", "lambda_p"):
                rg[name] += 0.5 * torch.randn(rg[name].shape, generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=dev)
    return params, lora, prompt


def to_fp32(tree):
    if isinstance(tree, dict):
        return {k: to_fp32(v) for k, v in tree.items()}
    return tree.float()


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def phase_slice(cfg, dev, params, lora, prompt) -> dict:
    # the main path, once, through the entry point a user calls
    torch.cuda.synchronize()
    for fn in KERNELS.values():
        fn.launches = 0
    for counts in VARIANTS.values():
        for kind in counts:
            counts[kind] = 0
    t0 = time.perf_counter()
    tokens = decode_tokens(params, cfg, prompt, NEW, lora=lora, device=dev)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    variants = {name: dict(counts) for name, counts in VARIANTS.items()}
    log(f"[slice] {cfg.name}: decode_tokens {tuple(tokens.shape)} in {serve_s:.3f} s "
        f"(first call), launches {launches}, by variant {variants}")
    assert tokens.shape == (BATCH, NEW) and tokens.dtype == torch.int64
    assert bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    assert launches == path_kernels(cfg), (launches, path_kernels(cfg))
    assert variants == path_variants(cfg), (variants, path_variants(cfg))

    # kernel path against the plain path (merged weights, _attend_full /
    # ssd_chunked), and both against the same function in fp32 (W + scale·A·B
    # unrounded, full fp32 products): the plain path's own error there is the
    # bf16 floor
    batch = {"tokens": prompt}
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    with torch.no_grad():
        cache = T.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
        logits, cache = T.prefill(params, batch, cfg, cache, lora=lora)
        merged = merge(params, lora, cfg)
        plain_cache = T.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
        plain, plain_cache = T.prefill(merged, batch, cfg, plain_cache, kernels=False)
        tok, plain_tok = logits[:, -1].argmax(-1), plain[:, -1].argmax(-1)
        step, _ = T.decode_step(params, plain_tok[:, None], cache, PROMPT, cfg, lora=lora)
        plain_step, _ = T.decode_step(merged, plain_tok[:, None], plain_cache, PROMPT, cfg)
        del merged, cache, plain_cache
        exact = merge(to_fp32(params), to_fp32(lora), cfg32)
        cache32 = T.init_cache(cfg32, BATCH, PROMPT + NEW, device=dev)
        ref, cache32 = T.prefill(exact, batch, cfg32, cache32, kernels=False)
        ref_step, _ = T.decode_step(exact, plain_tok[:, None], cache32, PROMPT, cfg32)
        del exact, cache32
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()
    assert torch.equal(tok, tokens[:, 0]), "decode_tokens' first token is the prefill's argmax"
    errs = {"prefill_kernel_vs_plain": rel_err(logits, plain),
            "prefill_kernel_vs_fp32": rel_err(logits, ref),
            "prefill_plain_vs_fp32": rel_err(plain, ref),
            "decode_kernel_vs_plain": rel_err(step, plain_step),
            "decode_kernel_vs_fp32": rel_err(step, ref_step),
            "decode_plain_vs_fp32": rel_err(plain_step, ref_step)}
    greedy = ties(logits[:, -1], plain[:, -1])
    log(f"[slice] {cfg.name}: logits relative errors " + json.dumps(errs))
    log(f"[slice] first-step greedy tokens equal on {greedy['equal']}/{BATCH} rows, "
        f"{greedy['ties']} tie(s)")
    # the kernel path may be no further from fp32 than twice the plain bf16
    # path is (both round to bf16, at different places), or 1e-3 where the
    # working type is fp32 itself
    for stage in ("prefill", "decode"):
        floor = max(2 * errs[f"{stage}_plain_vs_fp32"], 1e-3)
        assert errs[f"{stage}_kernel_vs_fp32"] <= floor, errs
    assert greedy["ok"], (tok.tolist(), plain_tok.tolist())
    return {"launches": launches, "variants": variants, "serve_first_call_s": serve_s,
            "errors": errs, "tokens_equal": greedy["equal"], "ties": greedy["ties"]}


def phase_timings(cfg, dev, params, lora, prompt) -> dict:
    gen = torch.Generator(device=dev).manual_seed(3)
    lcfg = cfg.lora or LoRAConfig()
    r, scale = lcfg.rank, lcfg.scale
    shapes = []

    def lora_call(x, w, a, b):
        return lora_matmul(x, w, a, b, scale=scale)

    def lora_plain(x, w, a, b):
        return lora_matmul_ref(x, w, a, b, scale=scale)

    def lora_library(x, w, a, b):
        return torch.addmm(x @ w, x @ a, b, alpha=scale)

    per_layer = lora_shapes(cfg)
    for M, calls_per_layer in ((BATCH * PROMPT, 1), (BATCH, NEW - 1)):
        for (K, N), n in per_layer.items():
            nbytes, ops = lora_work(M, K, N, r)
            sets = [lora_inputs(gen, M, K, N, r, dev) for _ in range(n_sets(nbytes))]
            b_ms, b_by = bound_ms(nbytes, ops)
            shapes.append(judge(dict(
                kernel="lora_matmul", M=M, K=K, N=N, r=r, dtype="bfloat16",
                variant=ran_variant("lora_matmul", lambda: lora_call(*sets[0])),
                launches=n * calls_per_layer * cfg.num_layers,
                ms=time_ms(lora_call, sets, 200), **device_time_ms(lora_call, sets, bound=b_ms),
                host_ms=host_ms(lora_call, sets),
                plain_ms=time_ms(lora_plain, sets, 50),
                library_ms=time_ms(lora_library, sets, 200),
                **library(device_time_ms(lora_library, sets, bound=b_ms)),
                bound_ms=b_ms, bound_by=b_by)))
            del sets
    shapes.append(ssd_timing(cfg, dev, gen) if cfg.layer_pattern == "M"
                  else flash_timing(cfg, dev, gen))
    for row in shapes:
        log(f"[timing] {cfg.name}: {json.dumps(row)}")

    # end to end: prefill, and decode steps against the prefilled cache
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        cache = T.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
        T.prefill(params, {"tokens": prompt}, cfg, cache, lora=lora)
        torch.cuda.synchronize()
        start.record()
        for _ in range(3):
            logits, cache = T.prefill(params, {"tokens": prompt}, cfg, cache, lora=lora)
        end.record()
        end.synchronize()
        prefill_ms = start.elapsed_time(end) / 3
        tok = logits[:, -1:].argmax(-1)
        start.record()
        for pos in range(PROMPT, PROMPT + NEW - 1):
            step, cache = T.decode_step(params, tok, cache, pos, cfg, lora=lora)
            tok = step[:, -1:].argmax(-1)
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / (NEW - 1)
        # where the device time goes; busy share = kernel time / event-timed call
        prefill_dev, prefill_top, _ = device_ms(
            lambda: T.prefill(params, {"tokens": prompt}, cfg, cache, lora=lora))
        step_dev, step_top, step_host = device_ms(
            lambda: T.decode_step(params, tok, cache, PROMPT + NEW - 1, cfg, lora=lora))
    t0 = time.perf_counter()
    decode_tokens(params, cfg, prompt, NEW, lora=lora, device=dev)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    e2e = {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
           "decode_tokens_per_s": BATCH / (step_ms / 1e3),
           "serve_call_s": serve_s, "serve_tokens_per_s": BATCH * NEW / serve_s,
           "prefill_device_ms": prefill_dev, "prefill_busy": share(prefill_dev, prefill_ms),
           "decode_step_device_ms": step_dev, "decode_busy": share(step_dev, step_ms),
           "prefill_top_kernels": prefill_top, "decode_top_kernels": step_top,
           "decode_top_host_ops": step_host}
    log(f"[timing] {cfg.name}: prefill {prefill_ms:.3f} ms (B={BATCH}, S={PROMPT}); decode step "
        f"{step_ms:.3f} ms = {e2e['decode_tokens_per_s']:.1f} tokens/s; one decode_tokens call "
        f"{serve_s:.3f} s = {e2e['serve_tokens_per_s']:.1f} tokens/s")
    log(f"[timing] {cfg.name}: device busy (ms of kernels, share of the call; None: not "
        f"measured): prefill {prefill_dev} ({e2e['prefill_busy']}), "
        f"decode step {step_dev} ({e2e['decode_busy']})")
    for name, top in (("prefill device", prefill_top), ("decode device", step_top),
                      ("decode host", step_host)):
        for key, ms, count in top:
            log(f"[profile] {cfg.name} {name} {ms:9.3f} ms  x{count:<4d} {key}")
    return {"shapes": shapes, "end_to_end": e2e}


def flash_timing(cfg, dev, gen) -> dict:
    H, Kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    nbytes, ops = attn_work(BATCH, PROMPT, H, Kv, d, True, 0)
    sets = [attn_inputs(gen, BATCH, PROMPT, H, Kv, d, dev) for _ in range(n_sets(nbytes))]
    b_ms, b_by = bound_ms(nbytes, ops)

    def call(q, k, v):
        return flash_attention(q, k, v, causal=True)

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                enable_gqa=True)

    return judge(dict(
        kernel="flash_attention", B=BATCH, S=PROMPT, H=H, Kv=Kv, d=d, causal=True,
        variant=ran_variant("flash_attention", lambda: call(*sets[0])),
        launches=cfg.num_layers,
        ms=time_ms(call, sets, 100), **device_time_ms(call, sets, bound=b_ms),
        plain_ms=time_ms(lambda q, k, v: flash_attention_ref(q, k, v, causal=True), sets, 20),
        library_ms=time_ms(sdpa, sets, 100), **library(device_time_ms(sdpa, sets, bound=b_ms)),
        bound_ms=b_ms, bound_by=b_by))


def ssd_path_inputs(gen, cfg, dev):
    """The SSD scan's inputs as the prefill hands them over: bf16 x, Bm, Cm
    as strided views of the conv output (B, S, conv_ch), fp32 dt, an initial
    state from the cache."""
    d_inner, H, P, N, conv_ch = M2.dims(cfg)
    xbc = torch.randn((BATCH, PROMPT, conv_ch), generator=gen, device=dev).mul(0.5).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn((BATCH, PROMPT, H), generator=gen,
                                                  device=dev) - 2)
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev))
    state = torch.randn((BATCH, H, P, N), generator=gen, device=dev)
    return (xbc[..., :d_inner].unflatten(-1, (H, P)), dt, A, xbc[..., d_inner:d_inner + N],
            xbc[..., d_inner + N:], state)


def ssd_timing(cfg, dev, gen) -> dict:
    """The SSD scan as the prefill calls it (``ssd_path_inputs``). Plain =
    the sequential recurrence (the wrapper's CPU version); ``chunked_ms``
    times the model's plain chunked path (PyTorch einsums), which the
    kernel's device time should be below (``below_chunked``). No single
    PyTorch call computes this function: no library time."""
    _, H, P, N, _ = M2.dims(cfg)
    nbytes, ops = ssd_work(BATCH, PROMPT, H, P, N, 2, True)
    sets = [ssd_path_inputs(gen, cfg, dev) for _ in range(n_sets(nbytes))]
    b_ms, b_by = bound_ms(nbytes, ops)

    def call(x, dt, A, Bm, Cm, h):
        return ssd_scan(x, dt, A, Bm, Cm, initial_state=h)

    def chunked(x, dt, A, Bm, Cm, h):
        return M2.ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk, h)

    row = judge(dict(
        kernel="ssd_scan", B=BATCH, S=PROMPT, H=H, P=P, N=N, chunk=cfg.ssm_chunk,
        variant=ran_variant("ssd_scan", lambda: call(*sets[0])),
        launches=cfg.num_layers,
        ms=time_ms(call, sets, 50), **device_time_ms(call, sets, 10, bound=b_ms),
        plain_ms=time_ms(ssd_scan_ref, sets, 3),
        chunked_ms=time_ms(chunked, sets, 10),
        library_ms=None, **library(None), bound_ms=b_ms, bound_by=b_by))
    row["below_chunked"] = row["device_ms"] < row["chunked_ms"]
    return row


def kernel_entries(results) -> list[dict]:
    """One entry per kernel; the times are summed over the launches that one
    serve call (prefill + NEW-1 decode steps) makes at each shape, over the
    serving paths that run the kernel."""
    meta = {
        "lora_matmul": ("src/repro_torch/csrc/lora_matmul.cu",
                        "src/repro/kernels/lora_matmul.py:51"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:84"),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:71"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        rows = [dict(s, path=arch) for arch, r in results.items()
                for s in r["timings"]["shapes"] if s["kernel"] == name]
        total = {k: sum(s[k] * s["launches"] for s in rows)
                 for k in ("ms", "device_ms", "graph_ms", "plain_ms", "bound_ms")}
        total["device_ms_by"] = dict(collections.Counter(s["device_ms_by"] for s in rows))
        for key in ("library_ms", "library_device_ms", "library_graph_ms"):
            lib = [s[key] for s in rows]
            total[key] = None if None in lib else sum(s[key] * s["launches"] for s in rows)
        verdicts = {v: f"{sum(bool(s[v]) for s in rows)}/{sum(s[v] is not None for s in rows)}"
                    for v in ("floor_met", "floor_met_device", "target_met")}
        verdicts["bound_half"] = f"{sum(s['bound_share'] >= 0.5 for s in rows)}/{len(rows)}"
        by_bytes = sum(s["bound_ms"] * s["launches"] for s in rows if s["bound_by"] == "bytes")
        by_path = {arch: r["slice"]["launches"][name] for arch, r in results.items()}
        variants = collections.Counter()
        for r in results.values():
            variants.update(r["slice"]["variants"].get(name, {}))
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": sum(by_path.values()), "launches_by_path": by_path,
                    "variants": dict(variants) if name in VARIANTS else None,
                    "rows": verdicts,
                    "max_abs_err": max(r["checks"]["max_abs_err"].get(name, 0.0)
                                       for r in results.values()), **total,
                    "bound_by": "bytes" if by_bytes >= total["bound_ms"] / 2 else "operations",
                    "per": "one decode_tokens call of each path: B=8, prompt 512, 32 new tokens",
                    "shapes": rows})
    return out


# Phase 4b's serves of the kernels' last inputs, at full width and depth:
# fedsllm-100m with 8 heads of 96 (phi-3-mini's head width; d_model 768
# kept) over 4 kv heads, whose flash runs at the 128-wide instance, and
# mamba2-130m with a state of 512, split across blocks in two slices
WIDE_HEADS, WIDE_STATE = "fedsllm-100m, 8 heads of 96", "mamba2-130m, state 512"


def wide_configs() -> dict:
    return {WIDE_HEADS: get_arch("fedsllm-100m").replace(num_heads=8, num_kv_heads=4,
                                                         head_dim=96),
            WIDE_STATE: get_arch("mamba2-130m").replace(ssm_state=512)}


def run_wide(name: str, cfg, dev) -> dict:
    """Phase 4b: phases 2 and 3 of a config outside the kernels' compiled
    widths (``wide_configs``): every kernel against its plain version at
    the config's widths (``phase_kernels``: flash at its heads and d, the
    SSD scan at its N, each in bf16 and fp32, ragged, windowed, capped or
    with an initial state), one serve held to phase 3's rules (launches by
    variant, logits against the plain path and fp32, greedy tokens), the
    kernel its layers launch timed at the serve's own shape
    (``flash_timing``/``ssd_timing``; no earlier time at these widths) and
    the prefill timed (CUDA events, mean of 3 after a warm call)."""
    t0 = time.perf_counter()
    checks = phase_kernels(cfg, dev)
    params, lora, prompt = make_model(cfg, dev)
    res = phase_slice(cfg, dev, params, lora, prompt)
    gen = torch.Generator(device=dev).manual_seed(3)
    timing = (ssd_timing if cfg.layer_pattern == "M" else flash_timing)(cfg, dev, gen)
    timing.update(earlier_ms=None, floor_met=None, floor_met_device=None)
    log(f"[timing] {name}: {json.dumps(timing)}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        cache = T.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
        T.prefill(params, {"tokens": prompt}, cfg, cache, lora=lora)
        start.record()
        for _ in range(3):
            T.prefill(params, {"tokens": prompt}, cfg, cache, lora=lora)
        end.record()
        end.synchronize()
    res.update(checks=checks, timing=timing, prefill_ms=start.elapsed_time(end) / 3)
    del params, lora, cache
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    log(f"[wide] {name}: prefill {res['prefill_ms']:.3f} ms (B={BATCH}, S={PROMPT}); "
        f"done in {res['seconds']:.1f} s")
    return res


def run_path(arch: str, dev) -> dict:
    """Phases 2-4 of one serving path."""
    cfg = get_arch(arch)
    t0 = time.perf_counter()
    checks = phase_kernels(cfg, dev)
    params, lora, prompt = make_model(cfg, dev)
    slice_res = phase_slice(cfg, dev, params, lora, prompt)
    timings = phase_timings(cfg, dev, params, lora, prompt)
    del params, lora
    torch.cuda.empty_cache()
    log(f"[path] {arch} done in {time.perf_counter() - t0:.1f} s")
    return {"checks": checks, "slice": slice_res, "timings": timings}


# ---------------------------------------------------------------------------
# phase 5: training, FedsLLM global rounds through build_round_fn
# ---------------------------------------------------------------------------

TRAIN_ARCH = "fedsllm-100m"
TRAIN_CUT = 1  # the reference Experiment's default cut, round(0.1 x 12 layers)
TRAIN_K, TRAIN_B, TRAIN_S = 4, 8, 256  # clients; the reference CLI's default batch, sequence
TRAIN_ETA = 0.5  # eta_train_max: I_loc = 11 by Lemma 2
TRAIN_ROUNDS = 3
TRAIN_MASKED = (1, 2)  # (round, client): the second round masks client 2 out
# limits, written in PERF.md §2 before the first run on the card
TRAIN_LIMITS = {
    # smoke round, card against CPU (fp32, TF32 off): of the largest value,
    # per adapter leaf and per metric
    "card_vs_cpu": 1e-4,
    # relative Frobenius per gradient leaf: the same autograd graph, cut or
    # not; one bf16 rounding of a gradient if anything sums in another order
    "split_vs_monolithic": 2.0 ** -8,
    # relative, loss_round_start: about 10x the reading of the first runs on
    # the card (4.6e-6): bf16 activations move the loss, a mean over 8192
    # tokens, that little
    "bf16_vs_fp32_loss": 5e-5,
    # relative Frobenius of the aggregated update h̄ (h̄_c and h̄_s each): in
    # bf16 the merged weights W + 2·A·B round away a small adapter step, and
    # the round-start gradient is a sum of per-token terms that nearly cancel,
    # so the two trajectories part within a round (0.42 and 0.25 in the first
    # runs): just above the larger reading
    "bf16_vs_fp32_hbar": 0.6,
    # ||h̄|| over ||h̄ in fp32|| (each side): the first runs' readings imply
    # 0.80 or 1.03 (client side) and 0.94 or 1.00 (server side); an update
    # scaled by 0.5 lands at 0.5 or below, inside the Frobenius limit above
    "bf16_vs_fp32_hbar_norm": (0.7, 1.43),
}


def to_dev(tree, dev):
    return tree_map(lambda t: t.to(dev), tree)


def flat(tree):
    return torch.cat([x.float().flatten() for x in tree_leaves(tree)])


def rel_frob(got, want) -> float:
    """Relative Frobenius distance of two trees, all leaves at once."""
    g, w = flat(got), flat(want)
    return ((g - w).norm() / w.norm()).item()


def cosine(a, b) -> float:
    a, b = flat(a), flat(b)
    return (torch.dot(a, b) / (a.norm() * b.norm())).item()


def zero_counters() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for counts in VARIANTS.values():
        for kind in counts:
            counts[kind] = 0


def train_parity(dev) -> dict:
    """Part (a): one gd round of smoke fedsllm-100m (fp32) on the card and on
    the CPU, from the same state and batches."""
    cfg = smoke_variant(get_arch(TRAIN_ARCH))
    K = 2
    state = fedsllm.init_state(cfg, cut=TRAIN_CUT, seed=0, device="cpu")
    batches = client_batches(TokenStream(2, 16, cfg.vocab_size, device="cpu"), 0, K)
    round_fn = fedsllm.build_round_fn(cfg, FedsLLMConfig(num_clients=K), TRAIN_CUT, 0.9)
    cpu_state, cpu_m = round_fn(state, batches)
    card_state, card_m = round_fn(to_dev(state, dev), to_dev(batches, dev))
    gaps = {"lora_c": tree_rel_gap(card_state.lora_c, cpu_state.lora_c),
            "lora_s": tree_rel_gap(card_state.lora_s, cpu_state.lora_s),
            **{k: tree_rel_gap(card_m[k], cpu_m[k]) for k in cpu_m}}
    log(f"[train] (a) smoke round, card vs CPU (of the largest value): {json.dumps(gaps)}")
    return gaps


def timed(fn):
    """fn()'s result and its time in ms between two CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_train(dev) -> dict:
    """Part (a), then part (b): TRAIN_ROUNDS rounds of full fedsllm-100m. No
    kernel may launch anywhere in the phase."""
    zero_counters()
    parity = train_parity(dev)
    cfg = get_arch(TRAIN_ARCH)
    fcfg = FedsLLMConfig(num_clients=TRAIN_K)
    I_loc = fedsllm.local_iteration_count(fcfg, TRAIN_ETA)
    passes = TRAIN_K * (1 + I_loc)  # round-start gradients, then I_loc steps, per client
    weights = torch.as_tensor(sample_network(fcfg, seed=0).D_k, dtype=torch.float32, device=dev)
    weighted = get_aggregator("weighted")
    round_fn = fedsllm.build_round_fn(cfg, fcfg, TRAIN_CUT, TRAIN_ETA, aggregator=weighted)
    stream = TokenStream(TRAIN_B, TRAIN_S, cfg.vocab_size, seed=0, device=dev)
    state = fedsllm.init_state(cfg, cut=TRAIN_CUT, seed=0, device=dev)
    masked_round, masked_client = TRAIN_MASKED
    mask = torch.ones(TRAIN_K, device=dev)
    mask[masked_client] = 0.0

    torch.cuda.reset_peak_memory_stats()
    rounds = []
    for r in range(TRAIN_ROUNDS):
        batches = client_batches(stream, r, TRAIN_K)
        m = mask if r == masked_round else None
        prev = state
        (state, metrics), ms = timed(lambda: round_fn(prev, batches, mask=m, weights=weights))
        rec = {"round": r, "seconds": ms / 1e3, "ms_per_pass": ms / passes,
               "masked_client": masked_client if m is not None else None,
               **{k: v.item() for k, v in metrics.items()}}
        if m is not None:
            # the masked client's batch swapped for another: nothing may move
            other = dict(batches, **{k: batches[k].clone() for k in ("tokens", "labels")})
            spare = stream.batch_at(10 ** 6)
            for k in ("tokens", "labels"):
                other[k][masked_client] = spare[k]
            again, _ = round_fn(prev, other, mask=m, weights=weights)
            rec["masked_batch_effect"] = max(
                (a.float() - b.float()).abs().max().item()
                for a, b in zip(tree_leaves((again.lora_c, again.lora_s)),
                                tree_leaves((state.lora_c, state.lora_s))))
            del again
        rounds.append(rec)
        log(f"[train] (b) round {r}: {json.dumps(rec)}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] {TRAIN_ROUNDS} rounds of {passes} split passes (K={TRAIN_K}, B={TRAIN_B}, "
        f"S={TRAIN_S}, I_loc={I_loc}); peak memory {peak / 2**30:.2f} GiB")

    # bf16 against fp32: the last round again, from the upcast state
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    round32 = fedsllm.build_round_fn(cfg32, fcfg, TRAIN_CUT, TRAIN_ETA, aggregator=weighted)
    prev32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, prev)
    new32, metrics32 = round32(fedsllm.FedsLLMState(*prev32), batches, weights=weights)
    hbar32 = {side: tree_map(lambda a, b: a - b, getattr(new32, side), getattr(prev32, side))
              for side in ("lora_c", "lora_s")}
    del new32, prev32

    def hbar_stats(new_state, scale=(1.0, 1.0)) -> dict:
        """h̄ of ``new_state`` (times ``scale``, per side) against fp32's."""
        out = {}
        for side, k in zip(("lora_c", "lora_s"), scale):
            h = tree_map(lambda a, b: k * (a.float() - b.float()), getattr(new_state, side),
                         getattr(prev, side))
            out[f"hbar_{side[-1]}"] = rel_frob(h, hbar32[side])
            out[f"hbar_{side[-1]}_norm"] = (flat(h).norm() / flat(hbar32[side]).norm()).item()
            out[f"hbar_{side[-1]}_cos"] = cosine(h, hbar32[side])
        return out

    def hbar_misses(st: dict) -> list:
        lo, hi = TRAIN_LIMITS["bf16_vs_fp32_hbar_norm"]
        return [f"h̄_{c} {st[f'hbar_{c}']:.3f} (norm ratio {st[f'hbar_{c}_norm']:.3f})"
                for c in ("c", "s") if not (st[f"hbar_{c}"] <= TRAIN_LIMITS["bf16_vs_fp32_hbar"]
                                            and lo <= st[f"hbar_{c}_norm"] <= hi)]

    bf16 = {"loss_round_start": abs(metrics["loss_round_start"].item()
                                    / metrics32["loss_round_start"].item() - 1),
            "loss_round_start_fp32": metrics32["loss_round_start"].item(),
            "loss_local_final_fp32": metrics32["loss_local_final"].item(),
            "h_c_norm_fp32": metrics32["h_c_norm"].item(), **hbar_stats(state)}
    log(f"[train] bf16 vs fp32, round {TRAIN_ROUNDS - 1}: {json.dumps(bf16)}")
    # the h̄ limits must reject wrong updates: this round's scaled by 0.5, and
    # the round again with the heaviest client left out of the average
    heavy = int(torch.argmax(weights))
    left_out = torch.ones(TRAIN_K, device=dev)
    left_out[heavy] = 0.0
    dropped, _ = round_fn(prev, batches, mask=left_out, weights=weights)
    wrong = {"update x0.5": hbar_stats(state, (0.5, 0.5)),
             "client side x0.5": hbar_stats(state, (0.5, 1.0)),
             "server side x0.5": hbar_stats(state, (1.0, 0.5)),
             f"client {heavy} left out": hbar_stats(dropped)}
    del dropped
    for name, st in wrong.items():
        st["rejected_by"] = hbar_misses(st)
        log(f"[train] wrong update '{name}': {json.dumps(st)}")

    # split == monolithic, one client batch, the last state
    batch = stream.batch_at(TRAIN_ROUNDS * TRAIN_K)
    loss_s, dc, ds, info = split.split_value_and_grad(state.base, state.lora_c, state.lora_s,
                                                      batch, cfg, TRAIN_CUT)
    loss_m, mdc, mds = split.monolithic_value_and_grad(state.base, state.lora_c, state.lora_s,
                                                       batch, cfg, TRAIN_CUT)
    split_gap = max(rel_frob(a, b) for a, b in zip(tree_leaves((dc, ds)), tree_leaves((mdc, mds))))
    log(f"[train] split vs monolithic: per-leaf relative Frobenius {split_gap:.3e}, loss "
        f"{loss_s.item():.6f} vs {loss_m.item():.6f}; info {json.dumps(info)}")

    # one split forward/backward: event time, device time and busy share
    def one_pass():
        return split.split_value_and_grad(state.base, state.lora_c, state.lora_s, batch, cfg,
                                          TRAIN_CUT)

    one_pass()
    pass_ms = sum(timed(one_pass)[1] for _ in range(5)) / 5
    dev_ms, top, host_top = device_ms(one_pass)
    try:
        pass_graph_ms, graph_error = graph_ms(one_pass, [()], iters=1), None
    except RuntimeError as e:  # a measurement, not a check: say why it is missing
        pass_graph_ms, graph_error = None, str(e)[:300]
    pass_dev = dev_ms if dev_ms is not None else pass_graph_ms
    profile = {"pass_ms": pass_ms, "pass_device_ms": dev_ms, "pass_graph_ms": pass_graph_ms,
               "pass_device_ms_by": "profiler" if dev_ms is not None else "cuda_graph",
               "graph_error": graph_error, "pass_busy": share(pass_dev, pass_ms),
               "top_kernels": top, "top_host_ops": host_top}
    log(f"[train] one split forward/backward: {pass_ms:.3f} ms (events), device "
        f"{dev_ms} ms (profiler), {pass_graph_ms} ms (CUDA graph), busy {profile['pass_busy']}")
    for name, rows in (("device", top), ("host", host_top)):
        for key, ms, count in rows:
            log(f"[profile] train pass {name} {ms:9.3f} ms  x{count:<5d} {key}")

    launches = {name: fn.launches for name, fn in KERNELS.items()}
    log(f"[train] kernel launches in the phase: {launches}")
    fails = []
    if max(parity.values()) > TRAIN_LIMITS["card_vs_cpu"]:
        fails.append(f"card vs CPU {parity}")
    if any(launches.values()):
        fails.append(f"training launched kernels {launches}")
    if not all(math.isfinite(r[k]) for r in rounds for k in
               ("loss_round_start", "loss_local_final", "h_c_norm")):
        fails.append("a metric is not finite")
    if rounds[masked_round]["masked_batch_effect"] != 0.0:
        fails.append(f"the masked client's batch moved the update by "
                     f"{rounds[masked_round]['masked_batch_effect']}")
    if not split_gap <= TRAIN_LIMITS["split_vs_monolithic"]:
        fails.append(f"split vs monolithic {split_gap}")
    if not bf16["loss_round_start"] <= TRAIN_LIMITS["bf16_vs_fp32_loss"]:
        fails.append(f"bf16 vs fp32 loss {bf16['loss_round_start']}")
    if hbar_misses(bf16):
        fails.append(f"bf16 vs fp32 {hbar_misses(bf16)}")
    for name, st in wrong.items():
        if not st["rejected_by"]:
            fails.append(f"the h̄ limits let the wrong update '{name}' pass: {st}")
    result = {"config": {"arch": TRAIN_ARCH, "cut": TRAIN_CUT, "K": TRAIN_K, "B": TRAIN_B,
                         "S": TRAIN_S, "eta": TRAIN_ETA, "I_loc": I_loc, "passes": passes,
                         "aggregator": "weighted", "masked": TRAIN_MASKED},
              "limits": TRAIN_LIMITS, "parity": parity, "rounds": rounds,
              "peak_memory_bytes": peak, "launches": launches, "bf16_vs_fp32": bf16,
              "wrong_updates": wrong,
              "split_vs_monolithic": split_gap, "info": info, "profile": profile,
              "fails": fails}
    (OUT / "train.json").write_text(json.dumps(result, indent=1))
    if fails:
        raise SystemExit(f"[train] {len(fails)} check(s) failed: {fails}")
    return result, {"cfg": cfg, "state": state, "batches": batches, "weights": weights,
                    "stream": stream, "peak": peak}


# ---------------------------------------------------------------------------
# phase 6: the round priced by the §IV allocator and run two-tier
# ---------------------------------------------------------------------------

PRICED_SCENARIO = "geo-blockfade"  # the legacy sample_network records no positions
PRICED_TOPOLOGIES = ("edge-agg", "star")  # edge-agg: 2 edges, two-tier aggregation
STRATEGIES = ("proposed", "EB", "FE", "BA")
# relative width at which resource_alloc.solve_fixed_eta_exact ends its
# bisection on T: 'proposed' lands up to this far above the optimum, so
# above an EB allocation that is already optimal (a cell of one client)
SOLVER_RTOL = 1e-5
# limits, written in PERF.md §2 before the first run on the card
PRICED_LIMITS = {
    # relative Frobenius per leaf, ḡ of the same round-start gradients: for
    # a mean aggregator two-tier equals flat but for the bf16 rounding of
    # the edge means and fp32 associativity (2.5e-3 on the CPU, smoke model)
    "two_tier_vs_flat_aggregate": 2.0 ** -8,
    # relative Frobenius per leaf of the new adapters, the round in fp32
    # from the upcast state: two-tier equals flat up to fp32 associativity,
    # carried through the local steps (1.5e-6 on the CPU, smoke model)
    "two_tier_vs_flat_round_fp32": 2.0 ** -8,
    # the same in bf16: the bf16 round turns ulp-level differences of ḡ and
    # h̄ into a 10-16% different update (the first run on the card: 0.140
    # per leaf, h̄ 0.158 / 0.092), as phase 5's bf16-vs-fp32 h̄ shows; the
    # seed is the bf16 rounding of the edge means (ḡ 2.59e-3), since the
    # flat round with its clients reordered reads 0 (``reorder_gaps``); the
    # reference's own bf16 two-tier round parts from its flat round too
    # (2.2e-2 per leaf on the smoke model, tests/test_torch_net.py); about
    # 2x the reading, which the cross-edge weighting made uniform (0.559)
    # must fail
    "two_tier_vs_flat_round_bf16": 0.3,
}


def cells_of(assign, K: int, M: int) -> list:
    """Client indices of each cell (one cell of all K on the star)."""
    if assign is None:
        return [list(range(K))]
    return [[k for k in range(K) if assign[k] == m] for m in range(M)]


def price(name: str, fcfg, net0) -> dict:
    """Localize, allocate with every strategy and time the round on graph
    ``name``, on the host, as the reference Experiment's constructor does."""
    topo = get_topology(name)
    net, assign = topo.localize(fcfg, net0)
    out = {"topology": name, "num_edges": topo.num_edges, "two_tier": topo.two_tier,
           "assign": None if assign is None else [int(a) for a in assign], "strategies": {}}
    for s in STRATEGIES:
        t0 = time.perf_counter()
        alloc = topo.allocate(fcfg, net, assign, get_allocator(s), strategy=s,
                              eta_search="coarse")
        solve_s = time.perf_counter() - t0
        eta = min(float(alloc.eta), fcfg.eta_train_max)  # the training η the rounds run at
        timing = topo.round_timing(fcfg, net, alloc, eta, assign)
        times = {k: [float(x) for x in getattr(timing, k)]
                 for k in ("compute", "uplink_fed", "uplink_main", "backhaul", "total")
                 if getattr(timing, k, None) is not None}
        usage = [{"b_c": float(sum(alloc.b_c[i] for i in c)) / net.B_c,
                  "b_s": float(sum(alloc.b_s[i] for i in c)) / net.B_s}
                 for c in cells_of(assign, net.K, topo.num_edges) if c]
        out["strategies"][s] = {"T": float(alloc.T), "eta_star": float(alloc.eta),
                                "eta_train": eta, "feasible": bool(alloc.feasible),
                                "solve_s": solve_s, "bandwidth_share": usage,
                                "round_s": max(times["total"]), "times": times}
        log(f"[priced] {name} {s}: T {alloc.T:.1f} s, η* {alloc.eta:.2f}, feasible "
            f"{alloc.feasible}, round {max(times['total']):.2f} s at η {eta:.2f}; "
            f"solve {solve_s:.2f} s on the host; bandwidth share per cell {usage}")
        for k, v in times.items():
            log(f"[priced] {name} {s}   {k:11s} " + " ".join(f"{x:10.4f}" for x in v))
    T = {s: r["T"] for s, r in out["strategies"].items()}
    out["reduction_vs"] = {s: 1.0 - T["proposed"] / T[s] for s in ("EB", "FE", "BA")}
    log(f"[priced] {name}: assignment {out['assign']}; proposed against EB/FE/BA "
        f"{json.dumps(out['reduction_vs'])} (reduction of T)")
    return out


def priced_fails(p: dict) -> list:
    fails = []
    for s, r in p["strategies"].items():
        if not r["feasible"]:
            fails.append(f"{p['topology']} {s} infeasible")
        if any(u["b_c"] > 1.0 + 1e-9 or u["b_s"] > 1.0 + 1e-9 for u in r["bandwidth_share"]):
            fails.append(f"{p['topology']} {s} over its bandwidth budget {r['bandwidth_share']}")
        if not all(math.isfinite(x) for v in r["times"].values() for x in v):
            fails.append(f"{p['topology']} {s} has a time that is not finite")
        if s != "proposed" and not p["strategies"]["proposed"]["T"] <= r["T"] * (1 + SOLVER_RTOL):
            fails.append(f"{p['topology']} proposed T {p['strategies']['proposed']['T']} > "
                         f"{s} T {r['T']}")
    return fails


def leaf_gaps(got, want) -> list:
    """Relative Frobenius distance of each pair of leaves."""
    return [rel_frob(g, w) for g, w in zip(tree_leaves(got), tree_leaves(want))]


def phase_priced(dev, ctx) -> dict:
    """Part (a) on the host, part (b) on the card from phase 5's last state
    and batches. No kernel may launch anywhere in the phase."""
    zero_counters()
    fcfg = FedsLLMConfig(num_clients=TRAIN_K)
    net0 = get_scenario(PRICED_SCENARIO).initial_network(fcfg, 0)
    priced = {name: price(name, fcfg, net0) for name in PRICED_TOPOLOGIES}
    fails = [f for p in priced.values() for f in priced_fails(p)]

    p = priced["edge-agg"]
    M, assign = p["num_edges"], p["assign"]
    empty = [m for m in range(M) if m not in assign]
    eta_star = p["strategies"]["proposed"]["eta_star"]
    eta = min(eta_star, fcfg.eta_train_max)  # as the reference Experiment clamps it
    I_loc = fedsllm.local_iteration_count(fcfg, eta)
    passes = TRAIN_K * (1 + I_loc)
    log(f"[priced] (b) edge-agg assignment {assign}"
        + (f", empty cell(s) {empty}: run as drawn" if empty else "")
        + f"; η* {eta_star:.4f}, training η {eta:.4f}, I_loc {I_loc}")
    cfg, state, batches, weights = (ctx[k] for k in ("cfg", "state", "batches", "weights"))
    onehot = torch.eye(M, device=dev)[torch.as_tensor(assign, device=dev)]
    weighted = get_aggregator("weighted")

    def round_fn(aggregator, two_tier=True, model=cfg):
        return fedsllm.build_round_fn(model, fcfg, TRAIN_CUT, eta, aggregator=aggregator,
                                      two_tier=two_tier)

    two, flat = round_fn(weighted), round_fn(weighted, two_tier=False)
    torch.cuda.reset_peak_memory_stats()
    (two_state, two_m), ms = timed(lambda: two(state, batches, weights=weights, assign=onehot))
    peak = torch.cuda.max_memory_allocated()
    (flat_state, flat_m), flat_ms = timed(lambda: flat(state, batches, weights=weights))
    rec = {"seconds": ms / 1e3, "ms_per_pass": ms / passes, "flat_seconds": flat_ms / 1e3,
           "peak_memory_bytes": peak, "phase5_peak_memory_bytes": ctx["peak"],
           **{k: v.item() for k, v in two_m.items()},
           **{f"flat_{k}": v.item() for k, v in flat_m.items()}}

    def new(st):
        return st.lora_c, st.lora_s

    round_gaps = leaf_gaps(new(two_state), new(flat_state))
    hbar = {side: rel_frob(tree_map(lambda a, b: a.float() - b.float(), getattr(two_state, side),
                                    getattr(state, side)),
                           tree_map(lambda a, b: a.float() - b.float(), getattr(flat_state, side),
                                    getattr(state, side)))
            for side in ("lora_c", "lora_s")}

    # ḡ of the same round-start gradients, two-tier against flat
    grads = tree_stack([split.split_value_and_grad(state.base, state.lora_c, state.lora_s,
                                                   tree_index(batches, k), cfg, TRAIN_CUT)[1:3]
                        for k in range(TRAIN_K)])
    agg_gaps = [g for side in (0, 1) for g in leaf_gaps(
        federated.hier_aggregate(weighted, grads[side], onehot, weights=weights),
        weighted(grads[side], weights=weights))]
    del grads

    # the same round in fp32 from the upcast state, two-tier against flat
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    state32 = tree_map(lambda x: x.float() if x.is_floating_point() else x, state)
    two32, _ = round_fn(weighted, model=cfg32)(state32, batches, weights=weights, assign=onehot)
    flat32, _ = round_fn(weighted, two_tier=False, model=cfg32)(state32, batches,
                                                               weights=weights)
    round32_gaps = leaf_gaps(new(two32), new(flat32))
    del state32, two32, flat32

    # the flat round with its clients in reverse order: the same fp32 sums in
    # another order, no two-tier code (the CPU test reads the reference's
    # own two-tier-vs-flat gap)
    rev = torch.arange(TRAIN_K - 1, -1, -1, device=dev)
    rev_state, _ = flat(state, tree_map(lambda x: x[rev], batches), weights=weights[rev])
    reorder_gaps = leaf_gaps(new(rev_state), new(flat_state))
    del rev_state

    # a wrong two-tier update the bf16 round limit must reject: the edges
    # averaged uniformly, not by their clients' total weight
    wrong_state, _ = round_fn(get_aggregator("fedavg"))(state, batches, weights=weights,
                                                        assign=onehot)
    wrong_gap = max(leaf_gaps(new(wrong_state), new(flat_state)))
    del wrong_state, flat_state

    # a client masked out: its batch swapped for another moves nothing
    masked_client = TRAIN_MASKED[1]
    mask = torch.ones(TRAIN_K, device=dev)
    mask[masked_client] = 0.0
    a, _ = two(state, batches, mask=mask, weights=weights, assign=onehot)
    other = dict(batches, **{k: batches[k].clone() for k in ("tokens", "labels")})
    spare = ctx["stream"].batch_at(10 ** 6 + 1)
    for k in ("tokens", "labels"):
        other[k][masked_client] = spare[k]
    b, _ = two(state, other, mask=mask, weights=weights, assign=onehot)
    masked_effect = max((x.float() - y.float()).abs().max().item()
                        for x, y in zip(tree_leaves(new(a)), tree_leaves(new(b))))
    del a, b

    # median: the unrolled per-edge path
    med_state, med_m = round_fn(get_aggregator("median"))(state, batches, weights=weights,
                                                           assign=onehot)
    med_finite = (all(math.isfinite(v.item()) for v in med_m.values())
                  and all(bool(torch.isfinite(x).all()) for x in tree_leaves(new(med_state))))
    del med_state

    launches = {name: fn.launches for name, fn in KERNELS.items()}
    card = {**rec, "round_gap_max": max(round_gaps), "round_gaps": round_gaps,
            "round32_gap_max": max(round32_gaps), "round32_gaps": round32_gaps,
            "hbar_gap": hbar, "reorder_gap_max": max(reorder_gaps), "reorder_gaps": reorder_gaps,
            "aggregate_gap_max": max(agg_gaps), "aggregate_gaps": agg_gaps,
            "wrong_cross_edge_weighting_gap": wrong_gap, "masked_client": masked_client,
            "masked_batch_effect": masked_effect, "median_finite": med_finite,
            "launches": launches}
    summary = {k: v for k, v in card.items() if not k.endswith("gaps")}
    log(f"[priced] (b) two-tier round: {json.dumps(summary)}")
    if not card["aggregate_gap_max"] <= PRICED_LIMITS["two_tier_vs_flat_aggregate"]:
        fails.append(f"two-tier ḡ vs flat {card['aggregate_gap_max']}")
    if not card["round32_gap_max"] <= PRICED_LIMITS["two_tier_vs_flat_round_fp32"]:
        fails.append(f"two-tier fp32 round vs flat {card['round32_gap_max']}")
    if not card["round_gap_max"] <= PRICED_LIMITS["two_tier_vs_flat_round_bf16"]:
        fails.append(f"two-tier bf16 round vs flat {card['round_gap_max']}")
    if not wrong_gap > PRICED_LIMITS["two_tier_vs_flat_round_bf16"]:
        fails.append(f"the round limit let a uniform cross-edge weighting pass: {wrong_gap}")
    if not all(math.isfinite(rec[k]) for k in ("loss_round_start", "loss_local_final",
                                               "h_c_norm")):
        fails.append("a two-tier metric is not finite")
    if masked_effect != 0.0:
        fails.append(f"the masked client's batch moved the two-tier update by {masked_effect}")
    if not med_finite:
        fails.append("the median two-tier round is not finite")
    if any(launches.values()):
        fails.append(f"the priced phase launched kernels {launches}")
    result = {"config": {"scenario": PRICED_SCENARIO, "seed": 0, "K": TRAIN_K, "M": M,
                         "empty_cells": empty, "eta_star": eta_star, "eta_train": eta,
                         "I_loc": I_loc, "passes": passes, "aggregator": "weighted"},
              "limits": PRICED_LIMITS, "priced": priced, "card": card, "fails": fails}
    (OUT / "priced.json").write_text(json.dumps(result, indent=1))
    if fails:
        raise SystemExit(f"[priced] {len(fails)} check(s) failed: {fails}")
    return result


# ---------------------------------------------------------------------------
# phase 7: the Experiment facade, a campaign with checkpoint resume, codec and DP
# ---------------------------------------------------------------------------

CAMPAIGN_ROUNDS = 3
CAMPAIGN_RESUME = 2  # the fresh experiment resumes from the checkpoint after 2 rounds
DP_CLIP, DP_NOISE = 1.0, 0.5
# limits, written in PERF.md §6 before the first run on the card
CAMPAIGN_LIMITS = {
    # smoke run_round of the facade, card against CPU (fp32, TF32 off): of
    # the largest value, per adapter leaf and per metric (phase 5's limit)
    "card_vs_cpu": 1e-4,
    # every client's clipped update norm over the clip (fp32 scale, bf16 leaves)
    "dp_clip_ratio": 1.0 + 1e-3,
    # std of the DP noise on client 0's slot over σ·c, relative (~150k draws:
    # the std's own standard error is 0.2%)
    "dp_noise_std": 0.05,
}


class RoundClock:
    """Times each round of an experiment: CUDA events and host seconds around
    ``run_round`` (the round function), and the host seconds of the rest of
    the campaign loop since the last round (re-sampling, the allocator's
    re-solve, planning, the previous round's checkpoint)."""

    def __init__(self, exp, name: str = "round"):
        self.run_round, self.rows, self.mark = exp.run_round, [], time.perf_counter()
        self.name = name
        exp.run_round = self

    def __call__(self, batches, **kw):
        t = time.perf_counter()
        res, ms = timed(lambda: self.run_round(batches, **kw))
        self.last = {"device_round_s": ms / 1e3, "round_fn_host_s": time.perf_counter() - t}
        return res

    def on_round(self, rec) -> None:
        now = time.perf_counter()
        row = {"round": rec.round, **self.last,
               "host_outside_round_fn_s": now - self.mark - self.last["round_fn_host_s"],
               "alloc_T": float(rec.alloc.T), "eta": rec.eta, "round_time": rec.round_time,
               "cumulative_time": rec.cumulative_time,
               "mask": None if rec.mask is None else [float(m) for m in rec.mask],
               "simulated_total": [float(x) for x in rec.timing.total], **rec.metrics}
        self.mark = now
        self.rows.append(row)
        log(f"[campaign] {self.name} {rec.round}: T {row['alloc_T']:.1f} s, η {rec.eta:.2f}, mask "
            f"{row['mask']}, simulated round {rec.round_time:.2f} s; device "
            f"{row['device_round_s']:.3f} s, host outside round_fn "
            f"{row['host_outside_round_fn_s']:.3f} s; loss {rec.metrics['loss_round_start']:.6f}")


def same_bits(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def campaign_resume(dev, run_cfg, stream) -> tuple[dict, list]:
    """Part (a) and (b): the campaign, then a fresh experiment resumed from
    its round-2 checkpoint, both deterministic."""
    ckpt, resumed_dir = OUT / "campaign_ckpt", OUT / "campaign_resume"
    for d in (ckpt, resumed_dir):
        shutil.rmtree(d, ignore_errors=True)
    kw = dict(scenario="blockfade", topology="star", eta_search="warm", device=dev)
    t0 = time.perf_counter()
    exp = Experiment.from_config(run_cfg, **kw)
    ctor_s = time.perf_counter() - t0
    net0, alloc0 = exp.net, exp.alloc  # the constructor's solve, for the fresh experiment
    log(f"[campaign] {exp.describe()}; constructor {ctor_s:.1f} s on the host")
    # round 0's simulated per-client times as the campaign will price them
    # (events.round_state is pure): the deadline masks its slowest client
    total0 = events.round_state(exp, exp.seed, 0, reallocate=True)[-1].total
    deadline = float(np.mean(np.sort(total0)[-2:]))
    camp = dict(num_rounds=CAMPAIGN_ROUNDS, stream=stream, cohort=TRAIN_K, deadline=deadline,
                resample_channel=True, reallocate=True)
    clock = RoundClock(exp)
    torch.cuda.reset_peak_memory_stats()
    res = exp.run(checkpoint_dir=str(ckpt), checkpoint_every=1, on_round=clock.on_round, **camp)
    peak = torch.cuda.max_memory_allocated()

    # the checkpoint after round 2 alone, resumed by a fresh experiment
    shutil.copytree(ckpt, resumed_dir)
    for name in os.listdir(resumed_dir):
        if name.startswith("step_") and int(name.split("_")[1]) > CAMPAIGN_RESUME:
            shutil.rmtree(resumed_dir / name)
    fresh = Experiment.from_config(run_cfg, net=net0, alloc=alloc0, **kw)
    fresh_clock = RoundClock(fresh, "resumed round")
    rest = fresh.run(checkpoint_dir=str(resumed_dir), resume=True, on_round=fresh_clock.on_round,
                     **camp)
    resumed = {"rounds": [r.round for r in rest.records],
               "state_bitwise": same_bits(rest.state, res.state),
               "records_equal": all(a.metrics == b.metrics and a.round_time == b.round_time
                                    and a.eta == b.eta for a, b in
                                    zip(res.records[CAMPAIGN_RESUME:], rest.records)),
               "total_time": [res.total_time, rest.total_time], "clock": fresh_clock.rows}
    out = {"constructor_s": ctor_s, "deadline": deadline, "round0_simulated": list(total0),
           "rounds": clock.rows, "peak_memory_bytes": peak, "total_time": res.total_time,
           "trace_count": exp.trace_count, "eta_buckets": exp.eta_buckets, "resumed": resumed,
           "describe": exp.describe()}
    log(f"[campaign] (a) peak memory {peak / 2**30:.2f} GiB; resumed from round "
        f"{CAMPAIGN_RESUME}: rounds {resumed['rounds']}, state bit for bit "
        f"{resumed['state_bitwise']}, records equal {resumed['records_equal']}")
    log(f"[campaign] (b) trace_count {exp.trace_count}, η buckets {exp.eta_buckets}")
    fails = []
    if resumed["rounds"] != list(range(CAMPAIGN_RESUME, CAMPAIGN_ROUNDS)):
        fails.append(f"the resumed campaign ran rounds {resumed['rounds']}")
    if not (resumed["state_bitwise"] and resumed["records_equal"]
            and rest.total_time == res.total_time):
        fails.append("the resumed campaign differs from the uninterrupted one")
    if not any(r.stragglers for r in res.records):
        fails.append("the deadline masked no client")
    if any(r.survivors == 0 for r in res.records):
        fails.append("a round masked every client")
    if not exp.trace_count <= len(exp.eta_buckets):
        fails.append(f"trace_count {exp.trace_count} > {len(exp.eta_buckets)} η buckets")
    if not all(math.isfinite(v) for r in res.records for v in r.metrics.values()):
        fails.append("a campaign metric is not finite")
    del exp, fresh, res, rest
    for d in (ckpt, resumed_dir):  # 249 MB a checkpoint: nothing to keep
        shutil.rmtree(d, ignore_errors=True)
    return out, fails


def codec_and_dp(dev, run_cfg, stream) -> tuple[dict, list]:
    """Part (c): one round through the int8 uplink, one with DP. These price
    with ``EB`` (the campaign's ``proposed`` solve is phase 6's and (a)'s)."""
    batches = client_batches(stream, 0, TRAIN_K)
    fails, out = [], {}
    exp = Experiment.from_config(run_cfg, allocator="EB", compressor="int8", device=dev)
    info = split.split_value_and_grad(exp.state.base, exp.state.lora_c, exp.state.lora_s,
                                      tree_index(batches, 0), exp.cfg, exp.cut,
                                      compressor=exp.compressor)[3]
    elems = TRAIN_B * TRAIN_S * exp.cfg.d_model
    res, ms = timed(lambda: exp.run_round(batches))
    out["int8"] = {"info": info, "elems": elems, "s_bits": exp.fcfg.s_bits, "round_s": ms / 1e3,
                   **{k: v.item() for k, v in res.metrics.items()}}
    log(f"[campaign] (c) int8 round: {json.dumps(out['int8'])}")
    if info["smashed_bits_uplink"] != elems * 8 + 32:
        fails.append(f"int8 uplink bits {info['smashed_bits_uplink']} != {elems * 8 + 32}")
    if not all(math.isfinite(v.item()) for v in res.metrics.values()):
        fails.append("an int8 metric is not finite")
    del exp, res

    seen = {}
    noisy_fn = privacy.clip_and_noise_updates

    def watched(stacked, gen, *, clip_norm, noise_multiplier):
        noisy = noisy_fn(stacked, gen, clip_norm=clip_norm, noise_multiplier=noise_multiplier)
        clean = noisy_fn(stacked, None, clip_norm=clip_norm)
        K = tree_leaves(stacked)[0].shape[0]
        seen["raw_norms"] = [privacy.global_norm(tree_index(stacked, k)).item() for k in range(K)]
        seen["clipped_norms"] = [privacy.global_norm(tree_index(clean, k)).item()
                                 for k in range(K)]
        seen["others_exact"] = all(torch.equal(a[1:], b[1:]) for a, b in
                                   zip(tree_leaves(noisy), tree_leaves(clean)))
        noise = torch.cat([(a[0].float() - b[0].float()).flatten()
                           for a, b in zip(tree_leaves(noisy), tree_leaves(clean))])
        seen["noise_std"], seen["noise_mean"] = noise.std().item(), noise.mean().item()
        seen["noise_n"] = noise.numel()
        return noisy

    exp = Experiment.from_config(run_cfg, allocator="EB", dp_clip=DP_CLIP, dp_noise=DP_NOISE,
                                 device=dev)
    privacy.clip_and_noise_updates = watched
    try:
        res, ms = timed(lambda: exp.run_round(batches))
    finally:
        privacy.clip_and_noise_updates = noisy_fn
    out["dp"] = {"clip": DP_CLIP, "noise": DP_NOISE, "round_s": ms / 1e3, **seen,
                 **{k: v.item() for k, v in res.metrics.items()}}
    log(f"[campaign] (c) DP round: {json.dumps(out['dp'])}")
    if not seen or max(seen["clipped_norms"]) > DP_CLIP * CAMPAIGN_LIMITS["dp_clip_ratio"]:
        fails.append(f"a clipped update exceeds the clip: {seen.get('clipped_norms')}")
    if not seen.get("others_exact"):
        fails.append("DP noise reached a client slot other than client 0's")
    if not abs(seen.get("noise_std", 0.0) / (DP_NOISE * DP_CLIP) - 1) <= \
            CAMPAIGN_LIMITS["dp_noise_std"]:
        fails.append(f"DP noise std {seen.get('noise_std')} is not σ·c = {DP_NOISE * DP_CLIP}")
    if not all(math.isfinite(v.item()) for v in res.metrics.values()):
        fails.append("a DP metric is not finite")
    return out, fails


def facade_parity(dev) -> dict:
    """Part (d): one smoke round (fp32) of the facade on the card and on the
    CPU, from the same state and batches."""
    run_cfg = RunConfig(model=smoke_variant(get_arch(TRAIN_ARCH)), shape=SHAPES["train_4k"],
                        fedsllm=FedsLLMConfig(num_clients=2))
    cpu = Experiment.from_config(run_cfg, allocator="EB", device="cpu")
    card = Experiment.from_config(run_cfg, allocator="EB", device=dev)
    card.state = to_dev(cpu.state, dev)
    batches = client_batches(TokenStream(2, 16, run_cfg.model.vocab_size, device="cpu"), 0, 2)
    want, got = cpu.run_round(batches), card.run_round(to_dev(batches, dev))
    return {"lora_c": tree_rel_gap(got.state.lora_c, want.state.lora_c),
            "lora_s": tree_rel_gap(got.state.lora_s, want.state.lora_s),
            **{k: tree_rel_gap(got.metrics[k], want.metrics[k]) for k in want.metrics}}


def phase_campaign(dev) -> dict:
    """Parts (a)-(d) on the card; no kernel may launch anywhere in the phase."""
    zero_counters()
    cfg = get_arch(TRAIN_ARCH)
    run_cfg = RunConfig(model=cfg, shape=SHAPES["train_4k"],
                        fedsllm=FedsLLMConfig(num_clients=TRAIN_K))
    stream = TokenStream(TRAIN_B, TRAIN_S, cfg.vocab_size, seed=0, device=dev)
    torch.use_deterministic_algorithms(True)
    try:
        campaign, fails = campaign_resume(dev, run_cfg, stream)
    finally:
        torch.use_deterministic_algorithms(False)
    rounds, more = codec_and_dp(dev, run_cfg, stream)
    fails += more
    parity = facade_parity(dev)
    log(f"[campaign] (d) smoke round, card vs CPU (of the largest value): {json.dumps(parity)}")
    if max(parity.values()) > CAMPAIGN_LIMITS["card_vs_cpu"]:
        fails.append(f"card vs CPU {parity}")
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    log(f"[campaign] (e) kernel launches in the phase: {launches}")
    if any(launches.values()):
        fails.append(f"the campaign phase launched kernels {launches}")
    result = {"config": {"arch": TRAIN_ARCH, "K": TRAIN_K, "cohort": TRAIN_K, "B": TRAIN_B,
                         "S": TRAIN_S, "rounds": CAMPAIGN_ROUNDS, "resume_from": CAMPAIGN_RESUME,
                         "scenario": "blockfade", "topology": "star", "eta_search": "warm",
                         "cublas_workspace": os.environ.get("CUBLAS_WORKSPACE_CONFIG")},
              "limits": CAMPAIGN_LIMITS, "campaign": campaign, "codec_dp": rounds,
              "parity": parity, "launches": launches, "fails": fails}
    (OUT / "campaign.json").write_text(json.dumps(result, indent=1))
    if fails:
        raise SystemExit(f"[campaign] {len(fails)} check(s) failed: {fails}")
    return result


# ---------------------------------------------------------------------------
# phase 8: the fp32 and high-rank variants, the smoke serve, the training CLI,
# the pipelined split and the examples
# ---------------------------------------------------------------------------

CLI_ARCH = "fedsllm-100m"
CLI_STEPS, CLI_CKPT_EVERY = 20, 10
SMOKE_SERVE = (4, 32, 16)  # launch.serve's defaults: batch, prompt length, new tokens
# limits, written in PERF.md §6 before the first run on the card
CLI_LIMITS = {
    # fp32 LoRA against its plain version: of the largest output, the
    # reference's fp32 tolerance (tests/test_kernels.py)
    "lora_fp32": 1e-5,
    # fp32 flash: 2e-5 + 2e-5·|o| per element, the reference's
    "flash_fp32": 2e-5,
    # the fp32 smoke serve's logits, kernel path against plain, of the largest
    "smoke_serve_logits": 1e-4,
    # one step with microbatch=2 against the full batch, in fp32: relative
    # Frobenius per leaf of the first moment (1 - β1)·clip(g), the gradient
    # the AdamW update is made of (in bf16: ``microbatch_gaps``)
    "microbatch_vs_full": 2.0 ** -8,
    # pipelined_split_grads (M = 4) against the full-batch split step
    "pipelined_loss": 1e-3,
    "pipelined_grads": 2.0 ** -8,  # per leaf, phase 5's split-vs-monolithic
}


def lora_row(gen, dev, M, K, N, r, dtype, scale, launches=None, iters=100, device_iters=30,
             misaligned=False, **meta):
    """Event, device, plain, library (addmm) and bound times of one LoRA
    shape, beside its check against the plain version. ``misaligned``: x
    one element off a 16-byte boundary (TMA cannot read it)."""
    esize = 4 if dtype == torch.float32 else 2
    nbytes, ops = lora_work(M, K, N, r, esize)
    sets = [lora_inputs(gen, M, K, N, r, dev, dtype) for _ in range(n_sets(nbytes))]
    if misaligned:
        sets = [(torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view_as(x).copy_(x),
                 *rest) for x, *rest in sets]
    call = lambda x, w, a, b: lora_matmul(x, w, a, b, scale=scale)  # noqa: E731
    plain = lambda x, w, a, b: lora_matmul_ref(x, w, a, b, scale=scale)  # noqa: E731
    lib = lambda x, w, a, b: torch.addmm(x @ w, x @ a, b, alpha=scale)  # noqa: E731
    y = call(*sets[0])
    torch.cuda.synchronize()
    ref = plain(*sets[0])
    err = (y.float() - ref.float()).abs().max().item()
    tol = (CLI_LIMITS["lora_fp32"] * ref.abs().max().item() if dtype == torch.float32
           else bf16_ulps(ref))
    b_ms, b_by = lora_bound(M, K, N, r, dtype)
    row = dict(kernel="lora_matmul", M=M, K=K, N=N, r=r, dtype=str(dtype).split(".")[-1],
               misaligned=misaligned, **meta,
               variant=ran_variant("lora_matmul", lambda: call(*sets[0])),
               err=err, tol=tol, launches=launches, ms=time_ms(call, sets, iters),
               **device_time_ms(call, sets, device_iters, bound=b_ms),
               plain_ms=time_ms(plain, sets, max(5, iters // 4)), library_ms=time_ms(lib, sets, iters),
               **library(device_time_ms(lib, sets, device_iters, bound=b_ms)),
               bound_ms=b_ms, bound_by=b_by)
    row["bound_share"] = b_ms / row["device_ms"]
    return row


def attn_row(gen, dev, B, S, H, Kv, d, dtype, window=0, softcap=0.0, launches=None, iters=5,
             misaligned=False, causal=True, Skv=None, **meta):
    """One flash shape: the kernel against its plain version (bf16: 2 ulps of
    the largest output; fp32: 2e-5 + 2e-5·|o|), with event, device, plain,
    library and bound times. The library call is SDPA, where it computes the
    same function: no softcap; a window as its boolean mask. ``causal=False``
    with ``Skv`` keys: an encoder's or a cross-attention's shape."""
    fp32 = dtype == torch.float32
    nbytes, ops = attn_work(B, S, H, Kv, d, causal, window, esize=4 if fp32 else 2, Skv=Skv)
    sets = [attn_inputs(gen, B, S, H, Kv, d, dev, dtype, misaligned, Skv)
            for _ in range(n_sets(nbytes))]
    call = lambda q, k, v: flash_attention(q, k, v, causal=causal, window=window,  # noqa: E731
                                           softcap=softcap)
    plain = lambda q, k, v: flash_attention_ref(q, k, v, causal=causal,  # noqa: E731
                                                window=window, softcap=softcap)
    o = call(*sets[0])
    torch.cuda.synchronize()
    ref = plain(*sets[0])
    err = (o.float() - ref.float()).abs().max().item()
    if fp32:
        tol = CLI_LIMITS["flash_fp32"]
        excess = ((o - ref).abs() - tol * ref.abs()).max().item()
        ok = excess <= tol
    else:
        tol, excess = bf16_ulps(ref), None
        ok = err <= tol
    del o, ref
    lib = None
    if not softcap:
        mask = None
        if window:
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        lib = lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)
    b_ms, b_by = bound_ms(nbytes, ops, PEAK_FP32 if fp32 else PEAK_BF16)
    row = dict(kernel="flash_attention", dtype=str(dtype).split(".")[-1], B=B, S=S, H=H, Kv=Kv,
               d=d, window=window, softcap=softcap, misaligned=misaligned, causal=causal,
               Skv=Skv or S, **meta,
               variant=ran_variant("flash_attention", lambda: call(*sets[0])),
               err=err, excess=excess, tol=tol, ok=ok, launches=launches,
               ms=time_ms(call, sets, iters), **device_time_ms(call, sets, iters, bound=b_ms),
               plain_ms=time_ms(plain, sets, max(2, iters // 5)),
               library_ms=None if lib is None else time_ms(lib, sets, iters),
               **library(None if lib is None else device_time_ms(lib, sets, iters,
                                                                  bound=b_ms)),
               bound_ms=b_ms, bound_by=b_by)
    row["bound_share"] = b_ms / row["device_ms"]
    del sets
    torch.cuda.empty_cache()
    return row


# bf16 LoRA at ranks other than 16 (M, K, N, r): fedsllm-100m's w_gate/w_up
# at prefill and its wq at decode, at ranks 80, 128 and 256 (two launches),
# 4 (A's tiles copied by the producer warps), 100 (copied, two launches) and
# 512, and mistral-7b's w_gate (K=4096, N=14336) at rank 128, all on prefill
# or decode; then prefill and decode at shapes TMA cannot read (the first
# port's generic kernel's before their copied tiles): (M, K, N, r, x one
# element off 16 bytes), x misaligned at fedsllm-100m's w_gate (prefill) and
# wq (decode), K = 772 and N = 300 at both
WIDE_RANKS = [(BATCH * PROMPT, 768, 2048, r) for r in (80, 128, 256, 4, 100, 512)] + \
    [(BATCH, 768, 768, r) for r in (80, 128, 256, 4, 100, 512)] + \
    [(BATCH * PROMPT, 4096, 14336, 128), (BATCH, 4096, 14336, 128)]
COPIED = [(BATCH * PROMPT, 768, 2048, 16, True), (BATCH, 768, 768, 16, True),
          (BATCH, 772, 768, 16, False), (BATCH * PROMPT, 772, 768, 16, False),
          (BATCH, 768, 300, 16, False), (BATCH * PROMPT, 768, 300, 16, False)]
# fp32 decode at gemma2-9b's MLP (M = 2, its served batch): w_gate/w_up and
# w_down, 205 MB of W each, rank 16
GEMMA_FP32_DECODE = [(2, 3584, 14336), (2, 14336, 3584)]


def new_variants(dev) -> tuple[list, list]:
    """Part (a): the fp32 variant, bf16 ranks other than 16 and the shapes a
    tensor map cannot read against their plain versions (TF32 off), with their times and
    verdicts (``judge``), at full width (the smoke shapes are
    ``smoke_serve_rows'``)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    rows, fails = [], []
    scale = LoRAConfig().scale
    full = get_arch(CLI_ARCH)
    for M in (BATCH * PROMPT, BATCH):
        for K, N in ((768, 768), (768, 256), (768, 2048), (2048, 768)):
            rows.append(lora_row(gen, dev, M, K, N, 16, torch.float32, scale, expected="fp32",
                                 at="full width"))
    for r in (80, 128):
        for M, K, N in ((BATCH * PROMPT, 768, 2048), (BATCH, 768, 768)):
            rows.append(lora_row(gen, dev, M, K, N, r, torch.float32, scale, expected="fp32",
                                 at="rank > 64"))
    for M, K, N in GEMMA_FP32_DECODE:
        rows.append(lora_row(gen, dev, M, K, N, 16, torch.float32, scale, expected="fp32",
                             iters=30, at="gemma2-9b decode"))
    for M, K, N, r in WIDE_RANKS:
        expected = lora_binding.variant(M, K, N, r, True)
        assert expected == ("decode" if M <= 16 else "prefill")
        rows.append(lora_row(gen, dev, M, K, N, r, torch.bfloat16, scale, expected=expected,
                             iters=30 if K * N > 10 ** 7 else 100, at="rank != 16"))
    for M, K, N, r, misaligned in COPIED:
        rows.append(lora_row(gen, dev, M, K, N, r, torch.bfloat16, scale,
                             expected="decode" if M <= 16 else "prefill", misaligned=misaligned,
                             at="copied tiles"))
    for row in rows:
        judge(row)
    H, Kv, d = full.num_heads, full.num_kv_heads, full.head_dim
    for kw in (dict(B=BATCH, S=PROMPT, H=H, Kv=Kv, d=d), dict(B=2, S=PROMPT, H=8, Kv=2, d=128),
               dict(B=BATCH, S=PROMPT, H=H, Kv=Kv, d=d, window=128),
               dict(B=BATCH, S=PROMPT, H=H, Kv=Kv, d=d, softcap=50.0),
               dict(B=2, S=300, H=4, Kv=2, d=32, window=64, softcap=30.0)):
        rows.append(judge(dict(attn_row(gen, dev, dtype=torch.float32, iters=50, **kw),
                               expected="fp32")))
    for row in rows:
        log(f"[cli] (a) {json.dumps(row)}")
    return rows, row_fails(rows)


def row_fails(rows) -> list:
    """Rows whose variant is not the expected one or whose result is off its
    plain version's beyond the row's limit."""
    return [row for row in rows if row["variant"] != row["expected"] or not (
        row["excess"] <= row["tol"] if "excess" in row else row["err"] <= row["tol"])]


def counters() -> dict:
    return {name: dict(fn.variant_launches) for name, fn in KERNELS.items()}


def smoke_serve(dev) -> tuple[dict, list]:
    """Part (b): ``launch.serve.main(["--smoke"])`` on the card for both
    archs (every launch on the fp32 variants, SSD on ``tf32``), the fp32
    model's logits through the kernels against the plain path, and calls at
    other ranks: ``--smoke --lora-rank 80`` (fp32) and full-width bf16
    ``--lora-rank 80``, ``--lora-rank 100`` and ``--lora-rank 4`` (not
    multiples of 8: A's tiles copied), every one on ``prefill`` and
    ``decode`` only."""
    out, fails = {}, []
    B, P, NEW_S = SMOKE_SERVE
    calls = {arch: ["--arch", arch, "--smoke"] for arch in ARCHS}
    calls["fedsllm-100m rank 80 (fp32)"] = ["--smoke", "--lora-rank", "80"]
    small = ["--batch", "2", "--prompt-len", "64", "--max-new", "4"]
    calls["fedsllm-100m rank 80 (bf16)"] = ["--lora-rank", "80", *small]
    calls["fedsllm-100m rank 100 (bf16)"] = ["--lora-rank", "100", *small]
    calls["fedsllm-100m rank 4 (bf16)"] = ["--lora-rank", "4", *small]
    allowed = {"fedsllm-100m": {"lora_matmul": {"fp32"}, "flash_attention": {"fp32"}},
               "mamba2-130m": {"lora_matmul": {"fp32"}, "ssd_scan": {"tf32"}},
               "fedsllm-100m rank 80 (fp32)": {"lora_matmul": {"fp32"},
                                               "flash_attention": {"fp32"}},
               "fedsllm-100m rank 80 (bf16)": {"lora_matmul": {"prefill", "decode"},
                                               "flash_attention": {"wgmma"}},
               "fedsllm-100m rank 100 (bf16)": {"lora_matmul": {"prefill", "decode"},
                                                "flash_attention": {"wgmma"}},
               "fedsllm-100m rank 4 (bf16)": {"lora_matmul": {"prefill", "decode"},
                                              "flash_attention": {"wgmma"}}}
    for name, argv in calls.items():
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            tokens = serve.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        variants = counters()
        moved = {k: {v: n for v, n in c.items() if n} for k, c in variants.items()}
        ok = {k: set(v) for k, v in moved.items() if v} == allowed[name]
        out[name] = {"argv": argv, "seconds": seconds, "variants": variants,
                     "tokens_shape": list(tokens.shape), "printed": printed.getvalue()}
        log(f"[cli] (b) serve {' '.join(argv)}: {seconds:.2f} s, launches by variant {moved}")
        new = int(argv[argv.index("--max-new") + 1]) if "--max-new" in argv else NEW_S
        if not ok or tokens.shape[1] != new:
            fails.append(f"serve {argv}: launches {moved}, expected only {allowed[name]}")
    # the fp32 smoke model's logits through the kernels against the plain path
    for arch in ARCHS:
        cfg = smoke_variant(get_arch(arch))
        params, lora, _ = make_model(cfg, dev)
        tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=torch.Generator(
            device=dev).manual_seed(5), device=dev)
        with torch.no_grad():
            cache = T.init_cache(cfg, B, P + 1, device=dev)
            logits, cache = T.prefill(params, {"tokens": tokens}, cfg, cache, lora=lora)
            step, _ = T.decode_step(params, tokens[:, -1:], cache, P, cfg, lora=lora)
            merged = merge(params, lora, cfg)
            plain_cache = T.init_cache(cfg, B, P + 1, device=dev)
            plain, plain_cache = T.prefill(merged, {"tokens": tokens}, cfg, plain_cache,
                                           kernels=False)
            plain_step, _ = T.decode_step(merged, tokens[:, -1:], plain_cache, P, cfg)
        gaps = {stage: ((a - b).abs().max() / b.abs().max()).item()
                for stage, a, b in (("prefill", logits, plain), ("decode", step, plain_step))}
        out[f"{arch} logits"] = gaps
        log(f"[cli] (b) {cfg.name}: kernel path vs plain, of the largest logit {gaps}")
        if not max(gaps.values()) <= CLI_LIMITS["smoke_serve_logits"]:
            fails.append(f"{cfg.name} logits {gaps}")
    return out, fails


def ssd_row(gen, dev, B, S, H, P, N, launches=None, iters=50, dtype=torch.float32,
            expected="tf32", misaligned=False, **meta) -> dict:
    """One SSD scan shape (fp32: the ``tf32`` variant; bf16: ``wgmma``)
    against the sequential recurrence, 1e-4 of the largest output, with
    event, device, plain and bound times (fp32 operations at ``PEAK_FP32``;
    no library call computes it). ``misaligned``: x, Bm and Cm one element
    off 16 bytes (no tensor map reads them)."""
    fp32 = dtype == torch.float32
    nbytes, ops = ssd_work(B, S, H, P, N, 4 if fp32 else 2, False)
    sets = [ssd_inputs(gen, B, S, H, P, N, dev, dtype) for _ in range(4)]
    if misaligned:
        sets = [(shifted(x), dt, A, shifted(Bm), shifted(Cm), h) for x, dt, A, Bm, Cm, h in sets]
    call = lambda x, dt, A, Bm, Cm, h: ssd_scan(x, dt, A, Bm, Cm)  # noqa: E731
    y, h = call(*sets[0])
    torch.cuda.synchronize()
    yr, hr = ssd_scan_ref(*sets[0][:5])
    b_ms, b_by = bound_ms(nbytes, ops, PEAK_FP32 if fp32 else PEAK_BF16)
    row = dict(kernel="ssd_scan", dtype=str(dtype).split(".")[-1], B=B, S=S, H=H, P=P, N=N,
               misaligned=misaligned, **meta,
               variant=ran_variant("ssd_scan", lambda: call(*sets[0])),
               expected=expected,
               err=max((y - yr).abs().max().item(), (h - hr).abs().max().item()),
               tol=1e-4 * max(yr.abs().max().item(), hr.abs().max().item()),
               launches=launches, ms=time_ms(call, sets, iters),
               **device_time_ms(call, sets, bound=b_ms),
               plain_ms=time_ms(lambda x, dt, A, Bm, Cm, h: ssd_scan_ref(x, dt, A, Bm, Cm),
                                sets, 2),
               library_ms=None, **library(None), bound_ms=b_ms, bound_by=b_by,
               chunk64_ops=ssd_chunk_ops(B, S, H, P, N, 64), ops=ops)
    row["bound_share"] = b_ms / row["device_ms"]
    return row


# The redesigned rows of phase 8 (a)'s ``next_rows``: label -> (the earlier
# graph ms a launch, the kind of target). Earlier: this script's final run
# before the redesign (the first port's flash ``wmma`` and SSD ``fma``; the smoke
# SSD row: its device ms a launch; bf16 SSD: ``wgmma`` at mamba2-130m's
# widths, 0.966 ms of device time over a serve's 24 launches), NVIDIA H100
# 80GB HBM3 at 700 W. Floor: half the parent (launch-bound smoke row: within
# 10% of it; bf16 SSD: within 3%); target: no slower than SDPA's graph time
# (flash), twice the bound (fp32 SSD at mamba2-130m's widths). The head dims
# between the compiled widths and the states wider than 256 raised before
# (no parent), but N=320, which the first port's ``fma`` took (0.6519 ms).
NEXT_PARENT = {"flash d=16": (0.0758, "sdpa"), "flash d=32": (0.0958, "sdpa"),
               "flash q misaligned d=64": (0.1430, "sdpa"),
               "flash q misaligned d=128": (0.4346, "sdpa"),
               "flash q misaligned d=256": (2.661, "sdpa"),
               "flash k, v misaligned d=64": (None, "sdpa"),
               **{f"flash d={d}": (None, "sdpa") for d in (48, 80, 96, 160, 192)},
               "flash d=36 (copied rows)": (None, "sdpa"),
               "flash fp32 d=96": (None, "sdpa"),
               "ssd fp32 mamba2-130m widths": (0.4736, "bound"),
               "ssd fp32 smoke serve shape": (0.010, "launch"),
               "ssd bf16 mamba2-130m widths": (0.966 / 24, "parent"),
               "ssd bf16 copied x, B, C": (None, None),
               "ssd bf16 N=320": (0.6519, None),
               "ssd bf16 N=1024": (None, None), "ssd fp32 N=1024": (None, None)}


# next_rows' rows of the kernels' last inputs (head dims between the
# compiled widths, states wider than 256 but N=320, which replaced a row)
LAST_ROWS = {f"flash d={d}" for d in (48, 80, 96, 160, 192)} | {
    "flash d=36 (copied rows)", "flash fp32 d=96", "ssd bf16 N=1024", "ssd fp32 N=1024"}


def next_verdict(row: dict) -> dict:
    """The row's floor and target against ``NEXT_PARENT`` (graph ms)."""
    parent, kind = NEXT_PARENT[row["at"]]
    t = row["graph_ms"]
    floor = None if parent is None else parent * (1.1 if kind == "launch" else
                                                  1.03 if kind == "parent" else 0.5)
    target = {"sdpa": row.get("library_graph_ms"), "bound": 2 * row["bound_ms"]}.get(kind)
    row.update(parent_ms=parent, floor_ms=floor, target_ms=target,
               floor_met=None if floor is None else t <= floor,
               target_met=None if target is None else t <= target)
    return row


def next_rows(dev) -> list:
    """The designs of the first port's last two variants and the kernels'
    last inputs, timed beside their bounds, the parent's times and SDPA
    where it computes the same function (``NEXT_PARENT``): bf16 flash on
    ``wgmma`` at head dims 16 and 32 (native widths), 48, 80 and 96 (B=8 ×
    512, 12 heads over 4), 160 and 192 (B=2 × 2048, 16 over 8) and 36 (rows
    a tensor map cannot read: copied), each at its true d, and fp32 flash at
    96; with q's rows one element off 16 bytes (copied by the producer
    warps) at 64 (fedsllm-100m's prefill), 128 (phi4-mini's) and 256
    (gemma2-9b's heads at S=2048, no softcap), and with k's and v's at 64;
    the SSD scan's ``tf32`` at mamba2-130m's widths in fp32 (B=8 × 512, 24
    heads of 64, N=128) and at the smoke serve's shape (B=4 × 32, 8 heads of
    16, N=16), its ``wgmma`` at mamba2-130m's widths in bf16, aligned and
    with x, B and C one element off 16 bytes, and states wider than 256
    (split across blocks, B=2 × 512, 4 heads of 64): N=320 in bf16 (the
    first port's ``fma`` range) and N=1024 in bf16 and fp32."""
    gen = torch.Generator(device=dev).manual_seed(12)
    flash = lambda at, *shape, expected="wgmma", **kw: lambda: dict(  # noqa: E731
        attn_row(gen, dev, *shape, **kw), at=at, expected=expected)
    todo = [flash(f"flash d={d}", BATCH, PROMPT, 12, 4, d, torch.bfloat16, iters=20)
            for d in (16, 32, 48, 80, 96)]
    todo += [flash(f"flash d={d}", 2, 2048, 16, 8, d, torch.bfloat16, iters=10)
             for d in (160, 192)]
    todo += [flash("flash d=36 (copied rows)", BATCH, PROMPT, 12, 4, 36, torch.bfloat16,
                   iters=10),
             flash("flash fp32 d=96", BATCH, PROMPT, 12, 4, 96, torch.float32, iters=10,
                   expected="fp32")]
    todo += [flash(f"flash q misaligned d={d}", B, S, H, Kv, d, torch.bfloat16, iters=10,
                   misaligned=True)
             for B, S, H, Kv, d in ((BATCH, PROMPT, 12, 4, 64), (BATCH, PROMPT, 24, 8, 128),
                                    (2, 2048, 16, 8, 256))]
    todo.append(flash("flash k, v misaligned d=64", BATCH, PROMPT, 12, 4, 64, torch.bfloat16,
                      iters=10, misaligned="kv"))
    _, H, Pd, N, _ = M2.dims(get_arch("mamba2-130m"))
    _, sH, sP, sN, _ = M2.dims(smoke_variant(get_arch("mamba2-130m")))
    B, S, _ = SMOKE_SERVE
    ssd = lambda *shape, **kw: lambda: ssd_row(gen, dev, *shape, **kw)  # noqa: E731
    bf16 = dict(dtype=torch.bfloat16, expected="wgmma")
    todo += [ssd(BATCH, PROMPT, H, Pd, N, iters=20, at="ssd fp32 mamba2-130m widths"),
             ssd(B, S, sH, sP, sN, at="ssd fp32 smoke serve shape"),
             ssd(BATCH, PROMPT, H, Pd, N, iters=20, **bf16, at="ssd bf16 mamba2-130m widths"),
             ssd(BATCH, PROMPT, H, Pd, N, iters=20, **bf16, misaligned=True,
                 at="ssd bf16 copied x, B, C"),
             ssd(2, PROMPT, 4, 64, 320, iters=20, **bf16, at="ssd bf16 N=320"),
             ssd(2, PROMPT, 4, 64, 1024, iters=20, **bf16, at="ssd bf16 N=1024"),
             ssd(2, PROMPT, 4, 64, 1024, iters=20, at="ssd fp32 N=1024")]
    rows = []
    for make in todo:
        t = time.perf_counter()
        row = make()
        row["seconds"] = time.perf_counter() - t
        rows.append(next_verdict(row))
        log(f"[cli] (a) next {json.dumps(row)}")
    last = sum(r["seconds"] for r in rows if r["at"] in LAST_ROWS)
    log(f"[cli] (a) next rows in {sum(r['seconds'] for r in rows):.1f} s, of which the "
        f"{len(LAST_ROWS)} rows of the kernels' last inputs {last:.1f} s")
    return rows


def smoke_serve_rows(dev, launched: dict) -> tuple[list, list]:
    """The fp32 serve path's kernels against their plain versions, with their
    times, at the shapes one ``launch.serve --smoke`` call of each arch gives
    them (B=4, prompt 32, 16 new tokens), each with its launches in that call."""
    gen = torch.Generator(device=dev).manual_seed(9)
    B, P, NEW_S = SMOKE_SERVE
    rows = []
    for arch in ARCHS:
        cfg = smoke_variant(get_arch(arch))
        lcfg = cfg.lora or LoRAConfig()
        for M, calls in ((B * P, 1), (B, NEW_S - 1)):
            for (K, N), n in lora_shapes(cfg).items():
                rows.append(lora_row(gen, dev, M, K, N, lcfg.rank, torch.float32, lcfg.scale,
                                     iters=50, launches=n * calls * cfg.num_layers, path=arch,
                                     expected="fp32"))
        if cfg.layer_pattern == "M":
            _, H, Pd, N, _ = M2.dims(cfg)
            rows.append(ssd_row(gen, dev, B, P, H, Pd, N, launches=cfg.num_layers, path=arch))
        else:
            rows.append(judge(dict(attn_row(gen, dev, B, P, cfg.num_heads, cfg.num_kv_heads,
                                            cfg.head_dim, torch.float32,
                                            launches=cfg.num_layers, iters=50),
                                   path=arch, expected="fp32")))
    for row in rows:
        log(f"[cli] (b) serve-path row {json.dumps(row)}")
    # the rows' launches are those the two smoke serve calls made
    for name, variant in (("lora_matmul", "fp32"), ("flash_attention", "fp32"),
                          ("ssd_scan", "tf32")):
        want = sum(launched[arch]["variants"][name][variant] for arch in ARCHS)
        got = sum(r["launches"] for r in rows if r["kernel"] == name)
        assert got == want, (name, got, want)
    return rows, row_fails(rows)


def cli_standard(dev) -> tuple[dict, list]:
    """Part (c): the standard trainer at full width, its resume bit for bit,
    a microbatched step against the full batch, and its step time."""
    fails = []
    ckpt, resumed = OUT / "cli_ckpt", OUT / "cli_resume"
    for d in (ckpt, resumed):
        shutil.rmtree(d, ignore_errors=True)
    argv = ["--arch", CLI_ARCH, "--steps", str(CLI_STEPS), "--batch", str(TRAIN_B), "--seq",
            str(TRAIN_S), "--ckpt-every", str(CLI_CKPT_EVERY), "--log-every", "1"]
    zero_counters()
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            train.main([*argv, "--ckpt-dir", str(ckpt)])
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = [float(m.group(1)) for m in
                  re.finditer(r"^step\s+\d+\s+loss (\S+)", printed.getvalue(), re.M)]
        resumed.mkdir(parents=True)
        name = f"step_{CLI_CKPT_EVERY:010d}"
        shutil.copytree(ckpt / name, resumed / name)
        with contextlib.redirect_stdout(io.StringIO()) as printed_resumed:
            train.main([*argv, "--ckpt-dir", str(resumed)])
    finally:
        torch.use_deterministic_algorithms(False)
    want, _ = Checkpointer(str(ckpt)).restore(CLI_STEPS)
    got, _ = Checkpointer(str(resumed)).restore(CLI_STEPS)
    bitwise = same_bits(got, want)
    n_params = sum(t.numel() for t in tree_leaves(want[0]))
    dtypes = sorted({str(t.dtype) for t in tree_leaves(want[0])})
    moment_dtypes = sorted({str(t.dtype) for t in tree_leaves(want[1])})
    del want, got
    for d in (ckpt, resumed):  # 1.25 GB a checkpoint: nothing to keep
        shutil.rmtree(d, ignore_errors=True)
    log(f"[cli] (c) train {' '.join(argv)}: {seconds:.1f} s, losses {losses}, peak memory "
        f"{peak / 2**30:.2f} GiB, {n_params} params {dtypes}, moments {moment_dtypes}; "
        f"resumed from step {CLI_CKPT_EVERY}: bit for bit {bitwise}")
    if len(losses) != CLI_STEPS or not all(math.isfinite(x) for x in losses):
        fails.append(f"losses {losses}")
    elif not losses[-1] < losses[0]:
        fails.append(f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    if f"resumed from step {CLI_CKPT_EVERY}" not in printed_resumed.getvalue() or not bitwise:
        fails.append("the resumed run differs from the uninterrupted one")

    # the step itself: events, device time, busy share; microbatch 2 against full
    cfg = get_arch(CLI_ARCH)
    tcfg = TrainConfig(learning_rate=3e-4, total_steps=CLI_STEPS, warmup_steps=10, remat="none")
    step_fn, opt = steps.make_train_step(cfg, tcfg)
    params = T.init_params(cfg, seed=tcfg.seed, device=dev)
    state0 = opt.init(params)
    step0 = torch.zeros((), dtype=torch.int32, device=dev)
    batch = TokenStream(TRAIN_B, TRAIN_S, cfg.vocab_size, seed=0, device=dev).batch_at(0)
    full = step_fn(params, state0, step0, batch)
    micro = microbatch_gaps(cfg, tcfg, params, full[1]["m"], batch)
    p, st, stp = full[:3]
    del full
    p, st, stp, _ = step_fn(p, st, stp, batch)  # warm
    times = []
    for _ in range(5):
        (p, st, stp, _), ms = timed(lambda: step_fn(p, st, stp, batch))
        times.append(ms)
    dev_ms, top, host_top = device_ms(lambda: step_fn(p, st, stp, batch))
    step_ms = sum(times) / len(times)
    profile = {"step_ms": times, "step_ms_mean": step_ms, "device_ms": dev_ms,
               "busy": share(dev_ms, step_ms), "top_kernels": top, "top_host_ops": host_top}
    log(f"[cli] (c) one train step (B={TRAIN_B}, S={TRAIN_S}): {step_ms:.2f} ms (events, mean of "
        f"5: {[round(t, 2) for t in times]}), device {dev_ms} ms, busy {profile['busy']}")
    for name, rows in (("device", top), ("host", host_top)):
        for key, ms, count in rows:
            log(f"[profile] train step {name} {ms:9.3f} ms  x{count:<5d} {key}")
    fails += micro.pop("fails")
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    if any(launches.values()):
        fails.append(f"the trainer launched kernels {launches}")
    return {"argv": argv, "seconds": seconds, "losses": losses, "peak_memory_bytes": peak,
            "params": n_params, "param_dtypes": dtypes, "moment_dtypes": moment_dtypes,
            "resumed_bitwise": bitwise, "microbatch": micro,
            "profile": profile, "launches": launches}, fails


def leaf_names(tree, path=()) -> list[str]:
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, path + (k,))]
    return ["/".join(path)]


def microbatch_gaps(cfg, tcfg, params, m_full, batch) -> dict:
    """One step with microbatch=2 against the full batch, by the AdamW first
    moment (1 - β1)·clip(g), per leaf (relative Frobenius): in fp32 (the
    params upcast), where only the accumulation differs (limit
    ``microbatch_vs_full``); and in bf16, the trainer's working type, where
    the two batch splits round their activation gradients differently: there
    the microbatched step may be no further from the fp32 step than twice
    the full batch's own distance from it, or 2^-8 (the rule phase 3 holds
    the kernel path to)."""
    micro_fn, opt = steps.make_train_step(cfg, dataclasses.replace(tcfg, microbatch=2))
    step0 = torch.zeros((), dtype=torch.int32, device=batch["tokens"].device)
    m_micro = micro_fn(params, opt.init(params), step0, batch)[1]["m"]
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    fn32, opt32 = steps.make_train_step(cfg32, tcfg)
    m32 = fn32(p32, opt32.init(p32), step0, batch)[1]["m"]
    micro32_fn, _ = steps.make_train_step(cfg32, dataclasses.replace(tcfg, microbatch=2))
    m32_micro = micro32_fn(p32, opt32.init(p32), step0, batch)[1]["m"]
    rows = []
    for name, a, b, c, d in zip(leaf_names(m_full), tree_leaves(m_full), tree_leaves(m_micro),
                                tree_leaves(m32), tree_leaves(m32_micro)):
        rows.append({"leaf": name, "bf16_micro_vs_full": rel_frob(b, a),
                     "bf16_full_vs_fp32": rel_frob(a, c), "bf16_micro_vs_fp32": rel_frob(b, c),
                     "fp32_micro_vs_full": rel_frob(d, c)})
    fails = []
    for r in rows:
        log(f"[cli] (c) microbatch 2 vs full batch, first moment: {json.dumps(r)}")
        limit = max(2 * r["bf16_full_vs_fp32"], 2.0 ** -8)
        if not r["bf16_micro_vs_fp32"] <= limit:
            fails.append(f"bf16 microbatch step {r}")
        if not r["fp32_micro_vs_full"] <= CLI_LIMITS["microbatch_vs_full"]:
            fails.append(f"fp32 microbatch step {r}")
    return {"leaves": rows, "fails": fails,
            **{k: max(r[k] for r in rows) for k in rows[0] if k != "leaf"}}


def cli_fedsllm(dev) -> tuple[dict, list]:
    """Part (d): the ``--fedsllm`` trainer at full width on the card, and the
    same command on the host with ``--smoke --device cpu``: the simulated
    times equal (the simulator ignores the model)."""
    argv = ["--fedsllm", "--clients", "4", "--rounds", "2", "--allocator", "EB",
            "--batch", str(TRAIN_B), "--seq", str(TRAIN_S)]
    seen, run = [], Experiment.run

    def recording(self, *a, **kw):
        seen.append(run(self, *a, **kw))
        return seen[-1]

    Experiment.run = recording
    printed, seconds = [], []
    try:
        for extra in ([], ["--smoke", "--device", "cpu"]):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                train.main([*argv, *extra])
            seconds.append(time.perf_counter() - t0)
            printed.append(out.getvalue())
    finally:
        Experiment.run = run
    card, host = seen
    times = [[(r.round_time, r.cumulative_time) for r in res.records] for res in (card, host)]
    losses = [{k: float(v) for k, v in r.metrics.items()} for r in card.records]
    log(f"[cli] (d) train {' '.join(argv)}: card {seconds[0]:.1f} s, host smoke "
        f"{seconds[1]:.1f} s; "
        f"simulated (round, cumulative) card {times[0]} host {times[1]}; losses {losses}")
    log("[cli] (d) printed on the card:\n" + printed[0].rstrip())
    fails = []
    if times[0] != times[1] or card.total_time != host.total_time:
        fails.append(f"simulated times differ: {times}")
    if not all(math.isfinite(v) for r in losses for v in r.values()):
        fails.append(f"losses {losses}")
    return {"argv": argv, "seconds": seconds, "simulated": times, "losses": losses,
            "printed": printed}, fails


def cli_pipelined(dev) -> tuple[dict, list]:
    """Part (e): ``pipelined_split_grads`` (M = 4) at full width against the
    full-batch split step, adapters with non-zero B."""
    cfg = get_arch(CLI_ARCH)
    state = fedsllm.init_state(cfg, cut=TRAIN_CUT, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    for side in (state.lora_c, state.lora_s):
        for ab in side.values():
            ab["B"] = (torch.randn(ab["B"].shape, generator=gen, device=dev)
                       * ADAPTER_B_STD).to(ab["B"].dtype)
    batch = TokenStream(TRAIN_B, TRAIN_S, cfg.vocab_size, seed=0, device=dev).batch_at(0)

    def full():
        return split.split_value_and_grad(state.base, state.lora_c, state.lora_s, batch, cfg,
                                          TRAIN_CUT)[:3]

    def piped():
        return pipelined_split_grads(state.base, state.lora_c, state.lora_s, batch, cfg,
                                     TRAIN_CUT, 4)

    (loss_f, dc_f, ds_f), (loss_p, dc_p, ds_p) = full(), piped()
    loss_gap = abs(loss_p.item() / loss_f.item() - 1)
    grad_gap = max(rel_frob(a, b) for a, b in zip(tree_leaves((dc_p, ds_p)),
                                                   tree_leaves((dc_f, ds_f))))
    ms = {name: [timed(fn)[1] for _ in range(3)] for name, fn in (("full", full),
                                                                  ("pipelined", piped))}
    log(f"[cli] (e) pipelined (M=4) vs full batch: loss {loss_gap:.3e}, grads per leaf "
        f"{grad_gap:.3e}; ms {json.dumps(ms)}")
    fails = []
    if not loss_gap <= CLI_LIMITS["pipelined_loss"]:
        fails.append(f"pipelined loss {loss_gap}")
    if not grad_gap <= CLI_LIMITS["pipelined_grads"]:
        fails.append(f"pipelined grads {grad_gap}")
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "ms": ms}, fails


def cli_examples(dev) -> tuple[dict, list]:
    """Part (f): the quickstart and serve demo on the card; their prefills
    launch the fp32 flash variant and, for mamba2, the SSD ``tf32``."""
    out, fails = {}, []
    for name, mod in (("quickstart", quickstart), ("serve_demo", serve_demo)):
        zero_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            mod.main([])
        torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t0, "variants": counters(),
                     "printed": printed.getvalue()}
        log(f"[cli] (f) {name}: {out[name]['seconds']:.1f} s, launches by variant "
            f"{out[name]['variants']}\n" + printed.getvalue().rstrip())
    if not out["quickstart"]["variants"]["flash_attention"]["fp32"] > 0:
        fails.append("quickstart launched no fp32 flash")
    demo = out["serve_demo"]["variants"]
    if not (demo["flash_attention"]["fp32"] > 0 and demo["ssd_scan"]["tf32"] > 0):
        fails.append(f"serve_demo launched {demo}")
    return out, fails


def phase_cli(dev) -> tuple[dict, list]:
    t0 = time.perf_counter()
    result, fails = {"limits": CLI_LIMITS}, []
    for part, fn in (("variants", new_variants), ("serve", smoke_serve),
                     ("standard", cli_standard), ("fedsllm", cli_fedsllm),
                     ("pipelined", cli_pipelined), ("examples", cli_examples)):
        t = time.perf_counter()
        result[part], more = fn(dev)
        result[f"{part}_seconds"] = time.perf_counter() - t
        fails += more
    rows, more = smoke_serve_rows(dev, result["serve"])
    result["serve_rows"] = rows
    result["next"] = next_rows(dev)
    more += [r for r in result["next"] if r["variant"] != r["expected"] or not (
        r["ok"] if r["kernel"] == "flash_attention" else r["err"] <= r["tol"])]
    result["fails"] = fails + more
    result["seconds"] = time.perf_counter() - t0
    (OUT / "cli.json").write_text(json.dumps(result, indent=1, default=str))
    if result["fails"]:
        raise SystemExit(f"[cli] {len(result['fails'])} check(s) failed: {result['fails']}")
    return result, rows


def rank_entries(cli) -> list[dict]:
    """The kernels line's entries of the bf16 LoRA variants at ranks other
    than 16 (``prefill`` and ``decode`` at ranks 80-512 and 4 and 100, A's
    tiles copied where r % 8 != 0; two launches a call above 64) and at the
    shapes a tensor map cannot read (``prefill`` and ``decode`` with copied
    tiles: x misaligned, K or N % 8 != 0), each with its times summed over
    phase 8 (a)'s rows that ran it (one launch at each shape) and its
    launches in the full-width bf16 serve that reaches it (``--lora-rank
    100``; no served path has a shape that needs copied x, W or B tiles:
    their launches are 0)."""
    out = []
    for variant, at, serve_call in (("prefill", "rank != 16", "fedsllm-100m rank 100 (bf16)"),
                                    ("decode", "rank != 16", "fedsllm-100m rank 100 (bf16)"),
                                    ("prefill", "copied tiles", None),
                                    ("decode", "copied tiles", None)):
        mine = [r for r in cli["variants"] if r["kernel"] == "lora_matmul"
                and r["dtype"] == "bfloat16" and r["variant"] == variant and r["at"] == at]
        total = {k: sum(r[k] for r in mine)
                 for k in ("ms", "device_ms", "graph_ms", "plain_ms", "bound_ms", "library_ms",
                           "library_device_ms")}
        by_bytes = sum(r["bound_ms"] for r in mine if r["bound_by"] == "bytes")
        launches = 0 if serve_call is None else \
            cli["serve"][serve_call]["variants"]["lora_matmul"][variant]
        out.append({"name": f"lora_matmul/{variant}" + (" r!=16" if serve_call else " copied"),
                    "route": "cuda", "source": "src/repro_torch/csrc/lora_matmul.cu",
                    "replaces": "src/repro/kernels/lora_matmul.py:51", "variant": variant,
                    "launches": launches, "launches_in": serve_call,
                    "max_abs_err": max(r["err"] for r in mine), **total,
                    "bound_by": "bytes" if by_bytes >= total["bound_ms"] / 2 else "operations",
                    "library": "addmm(x·W, x·A, B, alpha=scale)",
                    "rows": {v: f"{sum(bool(r[v]) for r in mine)}/"
                                f"{sum(r[v] is not None for r in mine)}"
                             for v in ("floor_met_device", "target_met")},
                    "per": "one launch at each of phase 8 (a)'s bf16 shapes on this variant: "
                           + ", ".join(f"{r['M']}x{r['K']}x{r['N']} r={r['r']}"
                                       + (" x misaligned" if r["misaligned"] else "")
                                       for r in mine)})
    return out


def next_entries(cli, wide) -> list[dict]:
    """The kernels line's entries of the designs of the first port's last
    two variants and of the kernels' last inputs, from phase 8 (a)'s
    ``next_rows``: flash ``wgmma`` at head dims 16 and 32, with copied tiles
    (rows one element off 16 bytes) and at the head dims between the
    compiled widths, fp32 flash at d=96, the SSD scan's ``tf32`` (fp32) at
    full width, its ``wgmma`` with copied tiles, and both above N=256 (split
    across blocks), times summed over one launch at each shape; no served
    path reaches these shapes (0 launches; the fp32 smoke serve's ``tf32``
    launches are ``variant_entries``'). Then one entry per wide serve
    (``run_wide``): its kernel timed at the serve's own shape, times summed
    over the launches one of its ``decode_tokens`` calls made."""
    out = []
    flash = ("src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:84")
    ssd = ("src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:71")
    between = {f"flash d={d}" for d in (48, 80, 96, 160, 192)} | {"flash d=36 (copied rows)"}
    for name, variant, (source, replaces), pick, launches in (
            ("flash_attention/wgmma d=16, 32", "wgmma", flash,
             lambda r: r["at"] in ("flash d=16", "flash d=32"), 0),
            ("flash_attention/wgmma copied", "wgmma", flash,
             lambda r: "misaligned" in r["at"], 0),
            ("flash_attention/wgmma d between the compiled widths", "wgmma", flash,
             lambda r: r["at"] in between, 0),
            ("flash_attention/fp32 d=96", "fp32", flash, lambda r: r["at"] == "flash fp32 d=96",
             0),
            ("ssd_scan/tf32 full width", "tf32", ssd,
             lambda r: r["at"] == "ssd fp32 mamba2-130m widths", 0),
            ("ssd_scan/wgmma copied", "wgmma", ssd, lambda r: r["at"] == "ssd bf16 copied x, B, C",
             0),
            ("ssd_scan/wgmma N > 256", "wgmma", ssd,
             lambda r: r["at"] in ("ssd bf16 N=320", "ssd bf16 N=1024"), 0),
            ("ssd_scan/tf32 N > 256", "tf32", ssd, lambda r: r["at"] == "ssd fp32 N=1024", 0)):
        mine = [r for r in cli["next"] if pick(r)]
        total = {k: sum(r[k] for r in mine)
                 for k in ("ms", "device_ms", "graph_ms", "plain_ms", "bound_ms")}
        for key in ("library_ms", "library_device_ms"):
            lib = [r[key] for r in mine]
            total[key] = None if None in lib else sum(lib)
        by_bytes = sum(r["bound_ms"] for r in mine if r["bound_by"] == "bytes")
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "variant": variant, "launches": launches,
                    "max_abs_err": max(r["err"] for r in mine), **total,
                    "bound_by": "bytes" if by_bytes >= total["bound_ms"] / 2 else "operations",
                    "rows": {v: f"{sum(bool(r[v]) for r in mine)}/"
                                f"{sum(r[v] is not None for r in mine)}"
                             for v in ("floor_met", "target_met")},
                    "per": "one launch at each shape: " + ", ".join(
                        r["at"] + f" B={r['B']} S={r['S']} H={r['H']}"
                        + (f" d={r['d']}" if "d" in r else f" P={r['P']} N={r['N']}")
                        for r in mine)})
    for name, (kernel, variant, (source, replaces)) in (
            (WIDE_HEADS, ("flash_attention", "wgmma", flash)),
            (WIDE_STATE, ("ssd_scan", "wgmma", ssd))):
        r = wide[name]["timing"]
        n = wide[name]["variants"][kernel][variant]
        out.append({"name": f"{kernel}/{variant} {name}", "route": "cuda", "source": source,
                    "replaces": replaces, "variant": variant, "launches": n,
                    "max_abs_err": wide[name]["checks"]["max_abs_err"][kernel],
                    **{k: r[k] * n for k in ("ms", "device_ms", "graph_ms", "plain_ms",
                                             "bound_ms")},
                    **{k: None if r[k] is None else r[k] * n
                       for k in ("library_ms", "library_device_ms")},
                    "bound_by": r["bound_by"],
                    "per": f"one decode_tokens call of {name}: B={BATCH}, prompt {PROMPT}, "
                           f"{NEW} new tokens; launches at B={r['B']} S={r['S']} H={r['H']} "
                           + (f"Kv={r['Kv']} d={r['d']}" if kernel == "flash_attention"
                              else f"P={r['P']} N={r['N']}")})
    return out


def variant_entries(rows) -> list[dict]:
    """One entry per variant that the fp32 serve path (phase 8 (b)) runs:
    times summed over the launches one ``launch.serve --smoke`` call of each
    arch makes at each shape."""
    meta = {"lora_matmul": ("fp32", "src/repro_torch/csrc/lora_matmul.cu",
                            "src/repro/kernels/lora_matmul.py:51"),
            "flash_attention": ("fp32", "src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:84"),
            "ssd_scan": ("tf32", "src/repro_torch/csrc/ssd_scan.cu",
                         "src/repro/kernels/ssd_scan.py:71")}
    out = []
    for name, (variant, source, replaces) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        assert all(r["variant"] == variant for r in mine), [r["variant"] for r in mine]
        total = {k: sum(r[k] * r["launches"] for r in mine)
                 for k in ("ms", "device_ms", "graph_ms", "plain_ms", "bound_ms")}
        for key in ("library_ms", "library_device_ms"):
            lib = [r[key] for r in mine]
            total[key] = None if None in lib else sum(r[key] * r["launches"] for r in mine)
        by_bytes = sum(r["bound_ms"] * r["launches"] for r in mine if r["bound_by"] == "bytes")
        out.append({"name": f"{name}/{variant}", "route": "cuda", "source": source,
                    "replaces": replaces, "variant": variant,
                    "launches": sum(r["launches"] for r in mine),
                    "max_abs_err": max(r.get("err", 0.0) for r in mine), **total,
                    "bound_by": "bytes" if by_bytes >= total["bound_ms"] / 2 else "operations",
                    "bound_peak": "fp32 at three TF32 products' rate, 165 TFLOP/s",
                    "per": "one launch.serve --smoke call of each arch: B=4, prompt 32, "
                           "16 new tokens, fp32"})
    return out


# ---------------------------------------------------------------------------
# phase 9: the rest of the dense family, and flash attention at head dim 256
# ---------------------------------------------------------------------------

GEMMA = "gemma2-9b"
GEMMA_SERVE = (2, 8192, 32)  # batch, prompt, new tokens
GEMMA_RULE_LAYERS = 4  # 2 LG groups: the logits rule's depth (fp32 at 42 layers is 37 GB)
GEMMA_FP32_NEW = 4  # new tokens of the fp32 serve through the kernels' fp32 variants
# the dense configs served at B=8, prompt 512, 32 new tokens: depth (None: full)
DENSE_SERVES = {"phi4-mini-3.8b": None, "starcoder2-7b": None, "command-r-35b": 8}
DENSE_ARCHS = ("phi4-mini-3.8b", "starcoder2-7b", "command-r-35b", GEMMA)
DENSE_TRAIN = {"arch": "phi4-mini-3.8b", "K": 2, "B": 4, "S": 256, "eta": 0.9, "cut": 1}
LAST = 128  # prompt positions whose prefill logits the checks compare
# limits, written in PERF.md §6 before the first run on the card
# (and phase 8's: flash fp32 2e-5 + 2e-5·|o|; the fp32 serve through the
# kernels against the plain fp32 path 1e-4 of the largest logit; phase 5's
# split == monolithic 2^-8 per leaf)
DENSE_LIMITS = {
    # the fp32 decode step after an 8192-token prefill (ring caches of 4096
    # slots) against the fp32 forward over the 8193 tokens, of the largest
    # logit: the same function, summed in another order
    "ring_vs_forward": 1e-4,
    "smoke_card_vs_cpu": 1e-4,  # the fp32 smoke forward, of the largest logit
}


def dense_kernels(dev) -> tuple[list, list]:
    """Part (a): flash at gemma2-9b's prefill shapes, bf16 (wgmma) and fp32,
    and once with q's rows misaligned for TMA (bf16 wgmma, q's tiles copied
    by the producer warps)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    cfg = get_arch(GEMMA)
    B, S = GEMMA_SERVE[:2]
    H, Kv, d, w, cap = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.sliding_window,
                        cfg.attn_logit_softcap)
    rows = []
    for dtype, expected in ((torch.bfloat16, "wgmma"), (torch.float32, "fp32")):
        for window, softcap, case in ((0, cap, "global"), (w, cap, "local"),
                                      (0, 0.0, "global, no softcap"),
                                      (w, 0.0, "local, no softcap")):
            rows.append(attn_row(gen, dev, B, S, H, Kv, d, dtype, window, softcap, case=case,
                                 expected=expected))
        rows.append(attn_row(gen, dev, B, 300, H, Kv, d, dtype, 64, 0.0, iters=20,
                             case="ragged", expected=expected))
    rows.append(attn_row(gen, dev, B, 300, H, Kv, d, torch.bfloat16, 64, cap, iters=20,
                         misaligned=True, case="misaligned", expected="wgmma"))
    for row in rows:
        if row["dtype"] == "float32":
            judge(row)
        log(f"[dense] (a) {json.dumps(row)}")
    return rows, [r for r in rows if not r["ok"] or r["variant"] != r["expected"]]


def dense_paths() -> list[tuple]:
    """Phase 9's serves through decode_tokens: (path, cfg, B, S, new, fp32);
    gemma2's 4-layer bf16 serve (the logits rule's) repeats the first's shapes."""
    g = get_arch(GEMMA)
    B, S, new = GEMMA_SERVE
    paths = [(GEMMA, g, B, S, new, False),
             (f"{GEMMA} fp32", g.replace(num_layers=GEMMA_RULE_LAYERS, dtype="float32",
                                         param_dtype="float32"), B, S, GEMMA_FP32_NEW, True)]
    for arch, layers in DENSE_SERVES.items():
        cfg = get_arch(arch)
        paths.append((arch, cfg.replace(num_layers=layers) if layers else cfg, BATCH, PROMPT, NEW,
                      False))
    return paths


def serve_lora_rows(dev, paths, seed: int, tag: str) -> tuple[list, list]:
    """Every LoRA shape that the serves ``paths`` launch (the prefill's
    M = B·S, an encoder's B·encoder_seq; the decode steps' M = B), held
    against its plain version (bf16:
    2 ulps of the largest output; fp32: 1e-5 of it) on the variant that the
    wrappers' rule gives it (``expected``, as ``dense_expected`` counts it),
    with its launches in that serve and its times."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for path, cfg, B, S, new, fp32 in paths:
        dtype = torch.float32 if fp32 else torch.bfloat16
        scale = (cfg.lora or LoRAConfig()).scale
        for (M, K, N, r), n in sorted(lora_plan(cfg, B, S, new).items()):
            stage = "decode" if M == B else "prefill"
            # an fp32 prefill product of gemma2 takes ~50 ms: few timed calls
            iters = {"prefill": 3 if fp32 else 10, "decode": 100}[stage]
            rows.append(lora_row(gen, dev, M, K, N, r, dtype, scale, launches=n, iters=iters,
                                 device_iters=min(iters, 30), path=path, stage=stage,
                                 expected=lora_binding.variant(M, K, N, r, True, fp32)))
            log(f"{tag} {json.dumps(rows[-1])}")
        torch.cuda.empty_cache()
    return rows, row_fails(rows)


def decode_split_sweep(dev, paths, seed: int, tag: str) -> tuple[list, list]:
    """The decode variant at every bf16 decode shape of the serves ``paths``
    with each cluster split of K from 1 to 8 blocks, against its plain
    version (2 bf16 ulps of the largest output at every split), its
    CUDA-graph device time at each; ``rule`` is the split the wrapper takes
    (``lora_matmul.decode_split``), ``best`` the fastest here."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = sorted({(M, K, N, r) for _, cfg, B, S, new, fp32 in paths if not fp32
                     for (M, K, N, r) in lora_plan(cfg, B, S, new) if M == B})
    rows, fails = [], []
    for M, K, N, r in shapes:
        nbytes, _ = lora_work(M, K, N, r)
        sets = [lora_inputs(gen, M, K, N, r, dev) for _ in range(n_sets(nbytes))]
        # the slice width, the u launch's split above rank 64, A copied or not
        bn, _, usplit, copy_a = lora_binding.plan(M, K, N, r, True)[1]
        ref = lora_matmul_ref(*sets[0], scale=2.0)
        row = dict(M=M, K=K, N=N, r=r, bn=bn, rule=lora_binding.decode_split(K, N), ms={}, err={})
        for split in range(1, lora_binding.DECODE_MAX_SPLIT + 1):
            fn = lambda x, w, a, b: lora_binding.lora_matmul_cuda(  # noqa: E731
                x, w, a, b, 2.0, "decode", (bn, split, usplit, copy_a))
            y = fn(*sets[0])
            torch.cuda.synchronize()
            row["err"][split] = (y.float() - ref.float()).abs().max().item()
            row["ms"][split] = graph_ms(fn, sets)
        row["tol"] = bf16_ulps(ref)
        row["best"] = min(row["ms"], key=row["ms"].get)
        row["library_graph_ms"] = graph_ms(
            lambda x, w, a, b: torch.addmm(x @ w, x @ a, b, alpha=2.0), sets)
        rows.append(row)
        log(f"{tag} decode split {json.dumps(row)}")
        if not max(row["err"].values()) <= row["tol"]:
            fails.append(row)
        del sets, ref
    torch.cuda.empty_cache()
    return rows, fails


@contextlib.contextmanager
def recording_flash():
    """The head dim, window and softcap of every flash call the model makes
    (the wrapper, and its counts, still run)."""
    calls, real = [], L.flash_attention

    def record(q, k, v, **kw):
        calls.append((q.shape[-1], kw["window"], kw["softcap"], kw["causal"]))
        return real(q, k, v, **kw)

    L.flash_attention = record
    try:
        yield calls
    finally:
        L.flash_attention = real


def counted_serve(params, cfg, prompt, new, lora, dev, inputs=None) -> tuple[torch.Tensor, dict]:
    """The main path once, through decode_tokens (``inputs``: its stub
    frame or patch embeddings), every count set to 0 just before and read
    just after."""
    torch.cuda.synchronize()
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    with recording_flash() as calls:
        t0 = time.perf_counter()
        tokens = decode_tokens(params, cfg, prompt, new, lora=lora, device=dev, inputs=inputs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return tokens, {"seconds": seconds, "launches": {n: fn.launches for n, fn in KERNELS.items()},
                    "variants": counters(), "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                    "flash_calls": {f"d={d} window={w} softcap={c} causal={causal}": n
                                    for (d, w, c, causal), n in
                                    collections.Counter(calls).items()}}


def lora_plan(cfg, B, S, new) -> collections.Counter:
    """(M, K, N, r) of each LoRA product in one decode_tokens call, with its
    launches: the prefill's at M = B·S (S: the positions it writes, a vlm
    prompt's patches included), the new-1 decode steps' at M = B; for
    encdec also the encoder's layers and the cross-attention's k/v
    products, once, at M = B·encoder_seq, and its q/o products as the
    decoder's."""
    r = (cfg.lora or LoRAConfig()).rank
    plan = collections.Counter()
    shapes = model_lora_shapes(cfg)
    if cfg.family == "encdec":
        D, q, kv = cfg.d_model, cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        shapes.update([(D, q), (q, D)] * cfg.num_layers)  # xattn wq, wo
        M_enc = B * cfg.encoder_seq
        for (K, N), n in lora_shapes(cfg).items():
            plan[(M_enc, K, N, r)] += n * cfg.num_encoder_layers
        plan[(M_enc, D, kv, r)] += 2 * cfg.num_layers  # xattn wk, wv
    for (K, N), n in shapes.items():
        plan[(B * S, K, N, r)] += n
        plan[(B, K, N, r)] += n * (new - 1)
    return plan


def dense_expected(cfg, B, S, new, fp32=False) -> dict:
    """Each variant's launches in one decode_tokens call, by the wrappers'
    own rule: bf16 LoRA products on ``prefill`` and ``decode``, flash on
    ``wgmma`` (``fp32`` in fp32), one a prefill's attention layer."""
    lora = dict.fromkeys(lora_matmul.variant_launches, 0)
    for (M, K, N, r), n in lora_plan(cfg, B, S, new).items():
        lora[lora_binding.variant(M, K, N, r, True, fp32)] += n
    flash = dict.fromkeys(flash_attention.variant_launches, 0)
    flash[flash_binding.variant(cfg.head_dim, fp32)] = flash_calls(cfg, S)
    return {"lora_matmul": lora, "flash_attention": flash,
            "ssd_scan": dict.fromkeys(ssd_scan.variant_launches, 0)}


def attention_layers(cfg) -> int:
    return sum(ch in "GL" for ch in cfg.pattern)


def flash_calls(cfg, S) -> int:
    """Flash calls of a prefill of S positions: one an attention layer, an
    encdec decoder layer's cross-attention too and one an encoder layer (a
    one-token prompt's self- and cross-attention are plain, as a decode
    step's)."""
    per_layer = 2 if cfg.family == "encdec" else 1
    return cfg.num_encoder_layers + (attention_layers(cfg) * per_layer if S > 1 else 0)


def served_fails(cfg, rec, B, S, new, fp32=False) -> list:
    fails = []
    want = dense_expected(cfg, B, S, new, fp32)
    if rec["variants"] != want:
        fails.append(f"{cfg.name}: launches by variant {rec['variants']}, expected {want}")
    calls = rec["flash_calls"]
    windowed = sum(n for k, n in calls.items() if "window=0 " not in k)
    free = sum(n for k, n in calls.items() if k.endswith("causal=False"))  # non-causal
    want_free = cfg.num_encoder_layers + (cfg.num_layers if cfg.family == "encdec" and S > 1
                                          else 0)
    if (windowed != cfg.pattern.count("L") or sum(calls.values()) != flash_calls(cfg, S)
            or free != want_free or not all(k.startswith(f"d={cfg.head_dim} ") for k in calls)):
        fails.append(f"{cfg.name}: flash calls {calls}")
    return fails


def merge_in_place(params, lora, cfg) -> None:
    """W = W + scale·A·B at every adapted leaf, in place, one stacked slice at
    a time (``lora.merge``'s arithmetic without a second copy of the model)."""
    scale = (cfg.lora or LoRAConfig()).scale
    for pstr, ab in lora.items():
        node = params
        *path, last = re.findall(r"\['([^']*)'\]", pstr)
        for key in path:
            node = node[key]
        w = node[last]
        for i in range(w.shape[0]) if w.ndim >= 3 else (slice(None),):
            delta = torch.einsum("...ir,...ro->...io", ab["A"][i].float(), ab["B"][i].float())
            w[i].copy_((w[i].float() + delta * scale).to(w.dtype))


def prefill_last(params, prompt, cfg, cache, *, lora=None, kernels=True, last=LAST,
                 inputs=None):
    """T.prefill's logits at the last ``last`` positions only (a long
    prompt's (B, S, V) fp32 logits are GBs); ``cache=None`` is a forward;
    ``inputs``: stub frame or patch embeddings."""
    batch = {"tokens": prompt, **(inputs or {})}
    enc_out = T._encode(params, batch, cfg, lora=lora, kernels=kernels)
    x, positions = T._embed_inputs(params, batch, cfg)
    x, _ = T._scan_groups(params, x, cfg, cache=cache, cache_pos=0, positions=positions,
                          lora=lora, kernels=kernels, q_chunk=T._q_chunk(x.shape[1]),
                          enc_out=enc_out)
    x = L.apply_norm(params["final_norm"], x[:, -last:], cfg)
    return L.lm_logits(params["embed"], x, cfg)


def group_of(params, lora, g, cfg=None):
    """Group ``g`` of the stack as a one-group stack: with ``cfg``, a copy in
    cfg's dtype with its adapters merged (``merge_in_place``: rounded to bf16
    as the plain path's weights are, or unrounded in fp32); else a view of
    the weights and the group's adapters, unmerged, for the kernels."""
    view = {"groups": tree_map(lambda t: t[g:g + 1], params["groups"])}
    ad = {k: {n: v[g:g + 1] for n, v in ab.items()} for k, ab in lora.items() if "groups" in k}
    if cfg is None:
        return view, ad
    dtype = torch.float32 if cfg.dtype == "float32" else None
    copy = {"groups": tree_map(lambda t: t.to(dtype or t.dtype, copy=True), view["groups"])}
    merge_in_place(copy, ad, cfg)
    return copy


def depth_checks(params, lora, prompt, cfg) -> tuple[dict, list]:
    """The full-depth model group by group at the served prompt: each group
    through the kernels (adapters unmerged), the plain bf16 path (merged) and
    fp32 (merged, unrounded) from the same input, the plain path's hidden
    state, with phase 3's rule on the group's update (output − input): the
    kernel path no further from fp32 than twice the plain path (or 1e-3).
    Beside it, each of the three run free from the embedding: how far apart
    they drift with depth (no check)."""
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    x, positions = T._embed_inputs(params, {"tokens": prompt}, cfg)
    free = {"kernel": x, "plain": x,
            "fp32": L.embed_tokens({"tokens": params["embed"]["tokens"]}, prompt, cfg32)}

    def run(gp, h, c, ad=None):
        return T._scan_groups(gp, h, c, positions=positions, lora=ad, kernels=ad is not None,
                              include_tail=False)[0]

    per_group, fails = [], []
    for g in range(T.n_full_groups(cfg)):
        view, ad = group_of(params, lora, g)
        plain_g, exact_g = group_of(params, lora, g, cfg), group_of(params, lora, g, cfg32)
        h = free["plain"]
        k, p, f = run(view, h, cfg, ad), run(plain_g, h, cfg), run(exact_g, h.float(), cfg32)
        e = {"kernel_vs_fp32": rel_err(k.float() - h.float(), f - h.float()),
             "plain_vs_fp32": rel_err(p.float() - h.float(), f - h.float())}
        free.update(kernel=run(view, free["kernel"], cfg, ad), plain=p,
                    fp32=run(exact_g, free["fp32"], cfg32))
        e.update(free_kernel_vs_plain=rel_err(free["kernel"], p),
                 free_kernel_vs_fp32=rel_err(free["kernel"], free["fp32"]),
                 free_plain_vs_fp32=rel_err(p, free["fp32"]))
        per_group.append(e)
        if not e["kernel_vs_fp32"] <= max(2 * e["plain_vs_fp32"], 1e-3):
            fails.append(f"{cfg.name}: group {g}'s update {e}")
        del view, ad, plain_g, exact_g, k, f
    worst = max(range(len(per_group)), key=lambda g: per_group[g]["kernel_vs_fp32"]
                / max(2 * per_group[g]["plain_vs_fp32"], 1e-3))
    log(f"[dense] {cfg.name} group by group ({len(per_group)} groups): the update's worst group "
        f"{worst} {json.dumps(per_group[worst])}; run free, after group g: kernel vs plain "
        f"{[round(e['free_kernel_vs_plain'], 4) for e in per_group]}, kernel vs fp32 "
        f"{[round(e['free_kernel_vs_fp32'], 4) for e in per_group]}, plain vs fp32 "
        f"{[round(e['free_plain_vs_fp32'], 4) for e in per_group]}")
    return {"groups": per_group, "worst_group": worst}, fails


def ties(kernel, plain) -> dict:
    """Greedy tokens of the kernel and plain paths' last logits, equal except
    a row whose plain top-2 gap is within twice their largest logit gap. At
    gemma2-9b's 42 random layers the two bf16 paths drift apart (0.8, as
    each does from fp32), so any token passes there: ``depth_checks`` is
    the check at that depth."""
    tok, ptok = kernel.argmax(-1), plain.argmax(-1)
    top2 = plain.topk(2, dim=-1).values
    tie = (tok != ptok) & (top2[:, 0] - top2[:, 1] <= 2 * (kernel - plain).abs().max())
    return {"equal": int((tok == ptok).sum()), "ties": int(tie.sum()),
            "ok": bool(((tok == ptok) | tie).all())}


def dense_serve(cfg, dev, B, S, new, rule: bool, fp32_served: bool = False,
                depth: bool = False) -> tuple[dict, list]:
    """One config served through decode_tokens (the counted main path), its
    prefill and decode timed; then, from the same weights, the kernel path's
    and the plain path's last-positions prefill logits and one decode step
    (teacher-forced to the same token), and with ``rule`` the same function
    in fp32 (W + scale·A·B unrounded) and phase 3's rule: the kernel path no
    further from fp32 than twice the plain path (or 1e-3); for a windowed
    config also the fp32 decode step against the fp32 forward over S+1
    tokens (the ring caches). ``fp32_served``: the fp32 model is also served
    through the kernels' fp32 variants (counted) and held against the plain
    fp32 path. ``depth``: ``depth_checks``, the rule group by group."""
    t0 = time.perf_counter()
    params, lora, prompt = make_model(cfg, dev, B, S)
    tokens, rec = counted_serve(params, cfg, prompt, new, lora, dev)
    fails = served_fails(cfg, rec, B, S, new)
    log(f"[dense] {cfg.name} ({cfg.num_layers} layers): decode_tokens {tuple(tokens.shape)} in "
        f"{rec['seconds']:.2f} s, peak {rec['peak_memory_bytes'] / 2**30:.2f} GiB, launches "
        f"{rec['launches']}, by variant {rec['variants']}, flash calls {rec['flash_calls']}")
    with torch.no_grad():
        cache = T.init_cache(cfg, B, S + new, device=dev)
        slots = {key: c["attn"][0].shape[2] for key, c in cache["groups"].items()}
        out, prefill_ms = timed(lambda: T.prefill(params, {"tokens": prompt}, cfg, cache,
                                                  lora=lora))
        del out  # gemma2's (B, S, V) fp32 logits are 16.8 GB
        torch.cuda.empty_cache()
        tok = tokens[:, :1]
        step_ms = []
        for pos in range(S, S + new - 1):
            (step, _), ms = timed(lambda: T.decode_step(params, tok, cache, pos, cfg, lora=lora))
            step_ms.append(ms)
            tok = step[:, -1:].argmax(-1)
        del cache
        rec.update(cache_slots=slots, prefill_ms=prefill_ms, decode_step_ms=sum(step_ms) / len(step_ms),
                   decode_tokens_per_s=B / (sum(step_ms) / len(step_ms) / 1e3))
        errs = {}
        if depth:
            rec["depth"], more = depth_checks(params, lora, prompt, cfg)
            fails += more
            torch.cuda.empty_cache()
        cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
        if rule:
            exact = tree_map(lambda t: t.to(torch.float32, copy=True), params)
            merge_in_place(exact, lora, cfg32)
            cache = T.init_cache(cfg32, B, S + 1, device=dev)
            ref = prefill_last(exact, prompt, cfg32, cache, kernels=False)
            feed = ref[:, -1:].argmax(-1)
            ref_step, _ = T.decode_step(exact, feed, cache, S, cfg32)
            del cache
            if cfg.sliding_window:
                fwd = prefill_last(exact, torch.cat([prompt, feed], 1), cfg32, None,
                                   kernels=False, last=1)
                errs["ring_vs_forward"] = ((ref_step - fwd).abs().max()
                                           / fwd.abs().max()).item()
                if not errs["ring_vs_forward"] <= DENSE_LIMITS["ring_vs_forward"]:
                    fails.append(f"{cfg.name}: ring decode vs forward {errs['ring_vs_forward']}")
                del fwd
            del exact
            if fp32_served:
                params32, lora32 = tree_map(lambda t: t.float(), (params, lora))
                toks32, rec32 = counted_serve(params32, cfg32, prompt, GEMMA_FP32_NEW, lora32, dev)
                fails += served_fails(cfg32, rec32, B, S, GEMMA_FP32_NEW, fp32=True)
                cache = T.init_cache(cfg32, B, S + 1, device=dev)
                got = prefill_last(params32, prompt, cfg32, cache, lora=lora32)
                errs["fp32_served_vs_fp32_plain"] = ((got - ref).abs().max()
                                                     / ref.abs().max()).item()
                rec["fp32_served"] = rec32
                log(f"[dense] {cfg32.name} served in fp32: launches by variant "
                    f"{rec32['variants']}, flash calls {rec32['flash_calls']}, logits vs plain "
                    f"fp32 {errs['fp32_served_vs_fp32_plain']:.3e} of the largest")
                if not errs["fp32_served_vs_fp32_plain"] <= CLI_LIMITS["smoke_serve_logits"]:
                    fails.append(f"{cfg.name}: fp32 served logits {errs}")
                del params32, lora32, cache, got, toks32
        else:
            feed = tokens[:, :1]
        cache = T.init_cache(cfg, B, S + 1, device=dev)
        logits = prefill_last(params, prompt, cfg, cache, lora=lora)
        step, _ = T.decode_step(params, feed, cache, S, cfg, lora=lora)
        del cache
        torch.cuda.empty_cache()
        merge_in_place(params, lora, cfg)
        cache = T.init_cache(cfg, B, S + 1, device=dev)
        plain = prefill_last(params, prompt, cfg, cache, kernels=False)
        plain_step, _ = T.decode_step(params, feed, cache, S, cfg)
        del cache, params, lora
    if not torch.equal(logits[:, -1].argmax(-1), tokens[:, 0]):
        fails.append(f"{cfg.name}: decode_tokens' first token is not the prefill's argmax")
    if not (torch.isfinite(logits).all() and torch.isfinite(step).all()):
        fails.append(f"{cfg.name}: non-finite logits")
    errs.update(prefill_kernel_vs_plain=rel_err(logits, plain),
                decode_kernel_vs_plain=rel_err(step, plain_step))
    greedy = {"prefill": ties(logits[:, -1], plain[:, -1]),
              "decode": ties(step[:, -1], plain_step[:, -1])}
    if rule:
        errs.update(prefill_kernel_vs_fp32=rel_err(logits, ref),
                    prefill_plain_vs_fp32=rel_err(plain, ref),
                    decode_kernel_vs_fp32=rel_err(step, ref_step),
                    decode_plain_vs_fp32=rel_err(plain_step, ref_step))
        for stage in ("prefill", "decode"):
            if not errs[f"{stage}_kernel_vs_fp32"] <= max(2 * errs[f"{stage}_plain_vs_fp32"],
                                                         1e-3):
                fails.append(f"{cfg.name}: {stage} logits rule {errs}")
    if not all(g["ok"] for g in greedy.values()):
        fails.append(f"{cfg.name}: greedy tokens {greedy}")
    rec.update(errors=errs, greedy=greedy, seconds_total=time.perf_counter() - t0,
               layers=cfg.num_layers, B=B, S=S, new=new)
    log(f"[dense] {cfg.name}: prefill {prefill_ms:.1f} ms, decode step "
        f"{rec['decode_step_ms']:.2f} ms = {rec['decode_tokens_per_s']:.1f} tokens/s; cache slots "
        f"{slots}; errors {json.dumps(errs)}; greedy {greedy}")
    torch.cuda.empty_cache()
    return rec, fails


def nonzero_b(lora, dev, seed: int) -> None:
    """B drawn N(0, ADAPTER_B_STD²), in place: B = 0 (the init) makes every
    A gradient zero."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for ab in lora.values():
        ab["B"] = (torch.randn(ab["B"].shape, generator=gen, device=dev)
                   * ADAPTER_B_STD).to(ab["B"].dtype)


def leaf_gap(got, want) -> float:
    return max(rel_frob(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))


def dense_train(dev) -> tuple[dict, list]:
    """Part (d): a FedsLLM round of full phi4-mini-3.8b and a split pass of
    full gemma2-9b (remat) against monolithic; no kernel may launch."""
    zero_counters()
    t = DENSE_TRAIN
    cfg = get_arch(t["arch"])
    fcfg = FedsLLMConfig(num_clients=t["K"])
    I_loc = fedsllm.local_iteration_count(fcfg, t["eta"])
    passes = t["K"] * (1 + I_loc)
    state = fedsllm.init_state(cfg, cut=t["cut"], seed=0, device=dev)
    nonzero_b(state.lora_c, dev, 1)
    nonzero_b(state.lora_s, dev, 2)
    stream = TokenStream(t["B"], t["S"], cfg.vocab_size, seed=0, device=dev)
    batches = client_batches(stream, 0, t["K"])
    weights = torch.tensor([3.0, 1.0], device=dev)
    round_fn = fedsllm.build_round_fn(cfg, fcfg, t["cut"], t["eta"],
                                      aggregator=get_aggregator("weighted"))
    round_fn(state, batches, weights=weights)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    (new, metrics), ms = timed(lambda: round_fn(state, batches, weights=weights))
    peak = torch.cuda.max_memory_allocated()
    metrics = {k: v.item() for k, v in metrics.items()}
    batch = stream.batch_at(t["K"])
    _, dc, ds, info = split.split_value_and_grad(new.base, new.lora_c, new.lora_s, batch, cfg,
                                                 t["cut"])
    _, mdc, mds = split.monolithic_value_and_grad(new.base, new.lora_c, new.lora_s, batch, cfg,
                                                  t["cut"])
    gap = leaf_gap((dc, ds), (mdc, mds))

    def one_pass():
        return split.split_value_and_grad(new.base, new.lora_c, new.lora_s, batch, cfg, t["cut"])

    pass_ms = sum(timed(one_pass)[1] for _ in range(3)) / 3
    dev_ms, top, _ = device_ms(one_pass)
    phi = {"config": dict(t, I_loc=I_loc, passes=passes, aggregator="weighted",
                          weights=weights.tolist()),
           "round_seconds": ms / 1e3, "ms_per_pass": ms / passes, "peak_memory_bytes": peak,
           "metrics": metrics, "split_vs_monolithic": gap, "pass_ms": pass_ms,
           "pass_device_ms": dev_ms, "pass_busy": share(dev_ms, pass_ms), "top_kernels": top}
    log(f"[dense] (d) {cfg.name} round: {json.dumps({k: v for k, v in phi.items() if k != 'top_kernels'})}")
    del state, new, dc, ds, mdc, mds, batches, round_fn
    torch.cuda.empty_cache()

    gcfg = get_arch(GEMMA)
    params = T.init_params(gcfg, seed=0, device=dev)
    lora = init_lora(params, gcfg, seed=1, device=dev)
    nonzero_b(lora, dev, 3)
    lc, ls = split_client_server(lora, 1)
    del lora
    batch = TokenStream(2, 256, gcfg.vocab_size, seed=1, device=dev).batch_at(0)
    torch.cuda.reset_peak_memory_stats()
    (loss, dc, ds, _), split_ms = timed(lambda: split.split_value_and_grad(
        params, lc, ls, batch, gcfg, 1, remat=True))
    split_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (mloss, mdc, mds), mono_ms = timed(lambda: split.monolithic_value_and_grad(
        params, lc, ls, batch, gcfg, 1))
    mono_peak = torch.cuda.max_memory_allocated()
    gemma = {"B": 2, "S": 256, "cut": 1, "remat": True, "loss": loss.item(),
             "monolithic_loss": mloss.item(), "split_vs_monolithic": leaf_gap((dc, ds), (mdc, mds)),
             "split_ms": split_ms, "monolithic_ms": mono_ms, "split_peak_memory_bytes": split_peak,
             "monolithic_peak_memory_bytes": mono_peak}
    log(f"[dense] (d) {gcfg.name} split pass: {json.dumps(gemma)}")
    del params, lc, ls, dc, ds, mdc, mds
    torch.cuda.empty_cache()
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    fails = []
    if any(launches.values()):
        fails.append(f"training launched kernels {launches}")
    if not all(math.isfinite(v) for v in metrics.values()):
        fails.append(f"{cfg.name} round metrics {metrics}")
    for name, g in ((cfg.name, gap), (gcfg.name, gemma["split_vs_monolithic"])):
        if not g <= TRAIN_LIMITS["split_vs_monolithic"]:
            fails.append(f"{name} split vs monolithic {g}")
    if not (math.isfinite(gemma["loss"]) and math.isfinite(gemma["monolithic_loss"])):
        fails.append(f"{gcfg.name} split loss {gemma}")
    return {"phi4_round": phi, "gemma2_split": gemma, "launches": launches}, fails


def dense_smoke(dev) -> tuple[dict, list]:
    """Part (e): the four smoke variants (fp32) on the card: the forward
    through the kernels' fp32 variants within 1e-4 of the CPU's plain
    versions, and ``launch.serve --smoke --arch <each>`` on the fp32 variants
    only."""
    out, fails = {}, []
    for arch in DENSE_ARCHS:
        cfg = smoke_variant(get_arch(arch))
        params, lora, prompt = make_model(cfg, torch.device("cpu"), 4, 40)
        with torch.no_grad():
            cpu = T.forward(params, {"tokens": prompt}, cfg, lora=lora)
            zero_counters()
            card = T.forward(to_dev(params, dev), {"tokens": prompt.to(dev)}, cfg,
                             lora=to_dev(lora, dev))
            torch.cuda.synchronize()
        fwd = {"gap": ((card.cpu() - cpu).abs().max() / cpu.abs().max()).item(),
               "variants": counters()}
        zero_counters()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            tokens = serve.main(["--arch", arch, "--smoke"])
        torch.cuda.synchronize()
        served = {"variants": counters(), "tokens_shape": list(tokens.shape),
                  "printed": printed.getvalue()}
        out[arch] = {"forward": fwd, "serve": served}
        log(f"[dense] (e) {cfg.name}: forward card vs CPU {fwd['gap']:.3e} of the largest; "
            f"serve --smoke launches by variant {served['variants']}")
        if not fwd["gap"] <= DENSE_LIMITS["smoke_card_vs_cpu"]:
            fails.append(f"{cfg.name}: card vs CPU {fwd['gap']}")
        for rec in (fwd, served):
            moved = {k: {v for v, n in c.items() if n} for k, c in rec["variants"].items()}
            if moved != {"lora_matmul": {"fp32"}, "flash_attention": {"fp32"}, "ssd_scan": set()}:
                fails.append(f"{cfg.name}: launches {rec['variants']}")
    return out, fails


def dense_entries(rows, res) -> list[dict]:
    """The kernels line's entries of the dense paths' flash variants: the
    d=256 wgmma variant (gemma2-9b's bf16 serve), the d=256 fp32 variant
    (gemma2 at 4 layers served in fp32) and the d=128 wgmma variant (the (c)
    serves); times summed over the launches one serve call makes at each
    shape, the library (SDPA) at the same shape without the softcap."""
    gemma = res["gemma2"]
    entries = []
    for name, dtype, launched in (
            ("flash_attention/wgmma-d256", "bfloat16", gemma["variants"]["flash_attention"]),
            ("flash_attention/fp32-d256", "float32",
             res["gemma2_rule"]["fp32_served"]["variants"]["flash_attention"])):
        kind = "fp32" if dtype == "float32" else "wgmma"
        mine = [r for r in rows if r["dtype"] == dtype and r["variant"] == kind]
        n_global = launched[kind] // 2  # LG: half the layers windowed
        shapes = []
        for case, n in (("global", launched[kind] - n_global), ("local", n_global)):
            row = next(r for r in mine if r["case"] == case)
            lib = next(r for r in mine if r["case"] == f"{case}, no softcap")
            shapes.append(dict(row, launches=n, **{k: lib[k] for k in lib if k.startswith("library")}))
        entries.append(flash_entry(name, kind, shapes, max(r["err"] for r in mine),
                                   "one decode_tokens call of gemma2-9b: B=2, prompt 8192" +
                                   (", 4 layers, fp32" if kind == "fp32" else ", 42 layers")))
    d128 = [dict(r, launches=res["serves"][r["path"]]["variants"]["flash_attention"]["wgmma"])
            for r in res["d128_rows"]]
    entries.append(flash_entry("flash_attention/wgmma-d128", "wgmma", d128,
                               max(r["err"] for r in d128),
                               "one decode_tokens call of each (c) config: B=8, prompt 512"))
    return entries


def lora_entries(rows, counted, paths) -> list[dict]:
    """The kernels line's entries of the LoRA kernel on the serves ``paths``,
    one per serve: its launches there (``counted[path]``), times summed over
    its launches at each shape (``serve_lora_rows``)."""
    out = []
    for path, cfg, B, S, new, fp32 in paths:
        mine = [r for r in rows if r["path"] == path]
        total = {k: sum(r[k] * r["launches"] for r in mine)
                 for k in ("ms", "device_ms", "graph_ms", "plain_ms", "bound_ms", "library_ms",
                           "library_device_ms")}
        by_bytes = sum(r["bound_ms"] * r["launches"] for r in mine if r["bound_by"] == "bytes")
        variants = collections.Counter()
        for r in mine:
            variants[r["variant"]] += r["launches"]
        out.append({"name": f"lora_matmul/{path}", "route": "cuda",
                    "source": "src/repro_torch/csrc/lora_matmul.cu",
                    "replaces": "src/repro/kernels/lora_matmul.py:51", "variants": dict(variants),
                    "launches": counted[path]["launches"]["lora_matmul"],
                    "max_abs_err": max(r["err"] for r in mine), **total,
                    "bound_by": "bytes" if by_bytes >= total["bound_ms"] / 2 else "operations",
                    "library": "addmm(x·W, x·A, B, alpha=scale)",
                    "per": f"one decode_tokens call of {cfg.name} ({cfg.num_layers} layers, "
                           f"{'fp32' if fp32 else 'bf16'}): B={B}, prompt {S}, {new} new tokens"})
    return out


def flash_entry(name, kind, shapes, err, per) -> dict:
    total = {k: sum(s[k] * s["launches"] for s in shapes)
             for k in ("ms", "device_ms", "graph_ms", "plain_ms", "bound_ms")}
    for key in ("library_ms", "library_device_ms"):
        lib = [s[key] for s in shapes]
        total[key] = None if None in lib else sum(s[key] * s["launches"] for s in shapes)
    by_bytes = sum(s["bound_ms"] * s["launches"] for s in shapes if s["bound_by"] == "bytes")
    return {"name": name, "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:84", "variant": kind,
            "launches": sum(s["launches"] for s in shapes), "max_abs_err": err, **total,
            "bound_by": "bytes" if by_bytes >= total["bound_ms"] / 2 else "operations",
            "library": "scaled_dot_product_attention at the same shape, without the softcap",
            "per": per}


def phase_dense(dev) -> tuple[dict, list]:
    """Parts (a)-(e) of phase 9; written to build/chip_smoke/dense.json."""
    t0 = time.perf_counter()
    res, fails = {"limits": DENSE_LIMITS}, []
    rows, more = dense_kernels(dev)
    res["kernel_rows"], fails = rows, fails + more
    res["lora_rows"], more = serve_lora_rows(dev, dense_paths(), 12, "[dense] (a)")
    fails += more
    res["decode_splits"], more = decode_split_sweep(dev, dense_paths(), 13, "[dense] (a)")
    fails += more
    gcfg = get_arch(GEMMA)
    B, S, new = GEMMA_SERVE
    res["gemma2"], more = dense_serve(gcfg, dev, B, S, new, rule=False, depth=True)
    fails += more
    res["gemma2_rule"], more = dense_serve(gcfg.replace(num_layers=GEMMA_RULE_LAYERS), dev, B, S,
                                           new, rule=True, fp32_served=True)
    fails += more
    slots = res["gemma2"]["cache_slots"]
    if not (slots["sub_0"] == gcfg.sliding_window < S + new and slots["sub_1"] == S + new):
        fails.append(f"gemma2 cache slots {slots}")
    res["serves"], res["d128_rows"] = {}, []
    gen = torch.Generator(device=dev).manual_seed(11)
    for arch, layers in DENSE_SERVES.items():
        cfg = get_arch(arch)
        cfg = cfg.replace(num_layers=layers) if layers else cfg
        res["serves"][arch], more = dense_serve(cfg, dev, BATCH, PROMPT, NEW, rule=True)
        fails += more
        row = attn_row(gen, dev, BATCH, PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       torch.bfloat16, iters=50, path=arch, expected="wgmma")
        log(f"[dense] (c) {json.dumps(row)}")
        res["d128_rows"].append(row)
        if not row["ok"] or row["variant"] != row["expected"]:
            fails.append(row)
    res["train"], more = dense_train(dev)
    fails += more
    res["smoke"], more = dense_smoke(dev)
    fails += more
    res["fails"], res["seconds"] = fails, time.perf_counter() - t0
    (OUT / "dense.json").write_text(json.dumps(res, indent=1, default=str))
    log(f"[dense] phase 9 in {res['seconds']:.1f} s")
    if fails:
        raise SystemExit(f"[dense] {len(fails)} check(s) failed: {fails}")
    counted = {GEMMA: res["gemma2"], f"{GEMMA} fp32": res["gemma2_rule"]["fp32_served"],
               **res["serves"]}
    return res, dense_entries(rows, res) + lora_entries(res["lora_rows"], counted, dense_paths())


# ---------------------------------------------------------------------------
# phase 10: the MoE family and the hybrid RG-LRU family
# ---------------------------------------------------------------------------

OLMOE, QWEN, RGEMMA = "olmoe-1b-7b", "qwen3-moe-235b-a22b", "recurrentgemma-9b"
# the serves: batch, prompt, new tokens, depth (None: full). qwen3 at 94
# layers of ~5 GB does not fit: 3 layers (~17 GB of bf16 weights with its
# untied 151,936-row embed and head) fit beside their fp32 copy; its rule
# runs at the same depth. recurrentgemma's prompt is twice its 2048 window,
# so its ring caches wrap and its windowed flash runs
FAMILY_SERVES = {OLMOE: (BATCH, PROMPT, NEW, None), QWEN: (BATCH, PROMPT, NEW, 3),
                 RGEMMA: (2, 4096, NEW, None)}
FAMILY_SPLIT = {"arch": OLMOE, "B": 4, "S": 256, "cut": 1}  # the full-width split pass
SMOKE_DEPTH = {RGEMMA: 5}  # an RRL group and an RR tail: layers on both sides of the cut
# limits, written in PERF.md §6 before the first run on the card (and phase
# 9's: the logits rule, ring decode vs forward 1e-4, greedy tokens)
FAMILY_LIMITS = {
    # a smoke split pass (fp32) on the card against the CPU's: loss and
    # every gradient leaf, of the largest value (phase 5's smoke round limit)
    "smoke_split_card_vs_cpu": 1e-4,
}


def family_paths() -> list[tuple]:
    """Phase 10's serves through decode_tokens: (path, cfg, B, S, new, fp32)."""
    paths = []
    for arch, (B, S, new, layers) in FAMILY_SERVES.items():
        cfg = get_arch(arch)
        paths.append((arch, cfg.replace(num_layers=layers) if layers else cfg, B, S, new, False))
    return paths


@contextlib.contextmanager
def recording_moe():
    """Every MoE layer call's routing (its top-k experts, (B, S, k)) and its
    (token, choice) pairs kept and dropped by capacity (the layers still
    run; the counts stay on the card until read)."""
    rec = {"routes": [], "kept": [], "pairs": []}
    route, rank = MOE.route, MOE._rank_and_dest

    def record_route(p, x, cfg):
        out = route(p, x, cfg)
        rec["routes"].append(out[1])
        return out

    def record_rank(top_e, E, C, k):
        dest, keep = rank(top_e, E, C, k)
        rec["kept"].append(keep.sum())
        rec["pairs"].append(keep.numel())
        return dest, keep

    MOE.route, MOE._rank_and_dest = record_route, record_rank
    try:
        yield rec
    finally:
        MOE.route, MOE._rank_and_dest = route, rank


def routing_flips(routes, other) -> tuple[list, torch.Tensor | None]:
    """Tokens whose top-k expert set differs between two runs, per MoE layer
    call, and the batch rows (B,) with a flip in any of them (None: no MoE)."""
    per_call, rows = [], None
    for a, b in zip(routes, other, strict=True):
        diff = (a.sort(-1).values != b.sort(-1).values).any(-1)  # (B, S)
        per_call.append(int(diff.sum()))
        rows = diff.any(-1) if rows is None else rows | diff.any(-1)
    return per_call, rows


def routed_ties(kernel, plain, flipped) -> dict:
    """``ties``, where a row's greedy token may also differ when routing
    flipped upstream in that row (``flipped``, (B,) or None)."""
    tok, ptok = kernel.argmax(-1), plain.argmax(-1)
    top2 = plain.topk(2, dim=-1).values
    diff = tok != ptok
    tie = diff & (top2[:, 0] - top2[:, 1] <= 2 * (kernel - plain).abs().max())
    flip = diff & ~tie & (flipped if flipped is not None else torch.zeros_like(diff))
    return {"equal": int((~diff).sum()), "ties": int(tie.sum()),
            "flipped_upstream": int(flip.sum()), "ok": bool((~diff | tie | flip).all())}


def family_serve(cfg, dev, B, S, new) -> tuple[dict, list]:
    """One config served through decode_tokens (the counted main path, MoE
    dispatch drops counted), its prefill and decode timed; then, from the
    same weights, the kernel path's, the plain bf16 path's and fp32's (W +
    scale·A·B unrounded) last-positions prefill logits and one decode step
    (teacher-forced to fp32's token), phase 3's logits rule on both, each MoE
    layer's routing flips between the kernel and plain paths (and against
    fp32), greedy tokens equal but for ties and rows whose routing flipped
    upstream, and for a windowed config the fp32 ring decode against the
    fp32 forward over S+1 tokens."""
    t0 = time.perf_counter()
    params, lora, prompt = make_model(cfg, dev, B, S)
    with recording_moe() as moe:
        tokens, rec = counted_serve(params, cfg, prompt, new, lora, dev)
    fails = served_fails(cfg, rec, B, S, new)
    if cfg.num_experts:
        kept, pairs = [int(k) for k in moe["kept"]], moe["pairs"]
        rec["dispatch"] = {"pairs": sum(pairs), "dropped": sum(pairs) - sum(kept),
                           "dropped_share": 1 - sum(kept) / sum(pairs),
                           # the prefill's layers (a decode step's never drop: C >= k)
                           "prefill_dropped_share_by_layer": [
                               round(1 - k / n, 4) for k, n in zip(kept[:cfg.num_layers],
                                                                   pairs[:cfg.num_layers])]}
    log(f"[families] {cfg.name} ({cfg.num_layers} layers): decode_tokens {tuple(tokens.shape)} "
        f"in {rec['seconds']:.2f} s, peak {rec['peak_memory_bytes'] / 2**30:.2f} GiB, launches "
        f"{rec['launches']}, by variant {rec['variants']}, flash calls {rec['flash_calls']}, "
        f"dispatch {rec.get('dispatch')}")
    errs, flips = {}, {}
    with torch.no_grad():
        cache = T.init_cache(cfg, B, S + new, device=dev)
        slots = {key: c["attn"][0].shape[2] for key, c in cache["groups"].items() if "attn" in c}
        out, prefill_ms = timed(lambda: T.prefill(params, {"tokens": prompt}, cfg, cache,
                                                  lora=lora))
        del out  # recurrentgemma's (B, S, V) fp32 logits are 8.4 GB
        torch.cuda.empty_cache()
        tok, step_ms = tokens[:, :1], []
        for pos in range(S, S + new - 1):
            (step, _), ms = timed(lambda: T.decode_step(params, tok, cache, pos, cfg, lora=lora))
            step_ms.append(ms)
            tok = step[:, -1:].argmax(-1)
        del cache
        rec.update(cache_slots=slots, prefill_ms=prefill_ms,
                   decode_step_ms=sum(step_ms) / len(step_ms),
                   decode_tokens_per_s=B / (sum(step_ms) / len(step_ms) / 1e3))
        cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
        exact = tree_map(lambda t: t.to(torch.float32, copy=True), params)
        merge_in_place(exact, lora, cfg32)
        with recording_moe() as r32:
            cache = T.init_cache(cfg32, B, S + 1, device=dev)
            ref = prefill_last(exact, prompt, cfg32, cache, kernels=False)
            feed = ref[:, -1:].argmax(-1)
            ref_step, _ = T.decode_step(exact, feed, cache, S, cfg32)
        del cache
        if cfg.sliding_window:
            fwd = prefill_last(exact, torch.cat([prompt, feed], 1), cfg32, None, kernels=False,
                               last=1)
            errs["ring_vs_forward"] = ((ref_step - fwd).abs().max() / fwd.abs().max()).item()
            if not errs["ring_vs_forward"] <= DENSE_LIMITS["ring_vs_forward"]:
                fails.append(f"{cfg.name}: ring decode vs forward {errs['ring_vs_forward']}")
            del fwd
        del exact
        torch.cuda.empty_cache()
        with recording_moe() as rk:
            cache = T.init_cache(cfg, B, S + 1, device=dev)
            logits = prefill_last(params, prompt, cfg, cache, lora=lora)
            step, _ = T.decode_step(params, feed, cache, S, cfg, lora=lora)
        del cache
        merge_in_place(params, lora, cfg)
        with recording_moe() as rp:
            cache = T.init_cache(cfg, B, S + 1, device=dev)
            plain = prefill_last(params, prompt, cfg, cache, kernels=False)
            plain_step, _ = T.decode_step(params, feed, cache, S, cfg)
        del cache, params, lora
    n_moe = len(rk["routes"]) // 2  # the prefill's MoE layers, then the decode step's
    flips["kernel_vs_plain"], rows = routing_flips(rk["routes"], rp["routes"])
    flips["kernel_vs_fp32"], _ = routing_flips(rk["routes"], r32["routes"])
    flips["plain_vs_fp32"], _ = routing_flips(rp["routes"], r32["routes"])
    _, pre_rows = routing_flips(rk["routes"][:n_moe], rp["routes"][:n_moe])
    if not torch.equal(logits[:, -1].argmax(-1), tokens[:, 0]):
        fails.append(f"{cfg.name}: decode_tokens' first token is not the prefill's argmax")
    if not (torch.isfinite(logits).all() and torch.isfinite(step).all()):
        fails.append(f"{cfg.name}: non-finite logits")
    errs.update(prefill_kernel_vs_plain=rel_err(logits, plain),
                decode_kernel_vs_plain=rel_err(step, plain_step),
                prefill_kernel_vs_fp32=rel_err(logits, ref),
                prefill_plain_vs_fp32=rel_err(plain, ref),
                decode_kernel_vs_fp32=rel_err(step, ref_step),
                decode_plain_vs_fp32=rel_err(plain_step, ref_step))
    for stage in ("prefill", "decode"):
        if not errs[f"{stage}_kernel_vs_fp32"] <= max(2 * errs[f"{stage}_plain_vs_fp32"], 1e-3):
            fails.append(f"{cfg.name}: {stage} logits rule {errs}")
    greedy = {"prefill": routed_ties(logits[:, -1], plain[:, -1], pre_rows),
              "decode": routed_ties(step[:, -1], plain_step[:, -1], rows)}
    if not all(g["ok"] for g in greedy.values()):
        fails.append(f"{cfg.name}: greedy tokens {greedy}")
    if cfg.num_experts:
        flips["flipped_rows"] = None if rows is None else int(rows.sum())
        flips["tokens_per_call"] = {"prefill": B * S, "decode": B}
    rec.update(errors=errs, greedy=greedy, routing_flips=flips,
               seconds_total=time.perf_counter() - t0, layers=cfg.num_layers, B=B, S=S, new=new)
    log(f"[families] {cfg.name}: prefill {prefill_ms:.1f} ms, decode step "
        f"{rec['decode_step_ms']:.2f} ms = {rec['decode_tokens_per_s']:.1f} tokens/s; cache slots "
        f"{slots}; errors {json.dumps(errs)}; greedy {greedy}")
    if cfg.num_experts:
        log(f"[families] {cfg.name}: routing flips per MoE layer call (prefill's {n_moe} of "
            f"{B * S} tokens, then the decode step's of {B}): kernel vs plain "
            f"{flips['kernel_vs_plain']}, kernel vs fp32 {flips['kernel_vs_fp32']}, plain vs "
            f"fp32 {flips['plain_vs_fp32']}; rows with a flip {flips['flipped_rows']} of {B}")
    torch.cuda.empty_cache()
    return rec, fails


def family_smoke(dev) -> tuple[dict, list]:
    """Part (e): one split pass of each family's smoke variant (fp32) on the
    card against the CPU's, from the same weights and batch (no kernel)."""
    out, fails = {}, []
    for arch in FAMILY_SERVES:
        cfg = smoke_variant(get_arch(arch))
        cfg = cfg.replace(num_layers=SMOKE_DEPTH.get(arch, cfg.num_layers))
        params, lora, _ = make_model(cfg, torch.device("cpu"), 2, 32)
        lc, ls = split_client_server(lora, 1)
        batch = TokenStream(2, 32, cfg.vocab_size, seed=0, device="cpu").batch_at(0)
        cpu = split.split_value_and_grad(params, lc, ls, batch, cfg, 1)
        zero_counters()
        card = split.split_value_and_grad(to_dev(params, dev), to_dev(lc, dev), to_dev(ls, dev),
                                          to_dev(batch, dev), cfg, 1)
        gaps = {"loss": abs(card[0].item() - cpu[0].item()) / abs(cpu[0].item()),
                "grads": tree_rel_gap(*([t for t in tree_leaves(g) if t.numel()]  # no empty side
                                        for g in (card[1:3], cpu[1:3]))),
                "launches": {n: fn.launches for n, fn in KERNELS.items()}}
        out[arch] = gaps
        log(f"[families] (e) {cfg.name} ({cfg.num_layers} layers) split pass, card vs CPU: "
            f"{json.dumps(gaps)}")
        if not (max(gaps["loss"], gaps["grads"]) <= FAMILY_LIMITS["smoke_split_card_vs_cpu"]
                and not any(gaps["launches"].values())):
            fails.append(f"{cfg.name}: smoke split pass {gaps}")
    return out, fails


def family_split(dev) -> tuple[dict, list]:
    """Part (e): one split pass of full-width olmoe-1b-7b (cut 1, B=4 × 256,
    non-zero B), its time and peak memory; no kernel may launch."""
    t = FAMILY_SPLIT
    cfg = get_arch(t["arch"])
    params = T.init_params(cfg, seed=0, device=dev)
    lora = init_lora(params, cfg, seed=1, device=dev)
    nonzero_b(lora, dev, 4)
    lc, ls = split_client_server(lora, t["cut"])
    del lora
    batch = TokenStream(t["B"], t["S"], cfg.vocab_size, seed=1, device=dev).batch_at(0)

    def one_pass():
        return split.split_value_and_grad(params, lc, ls, batch, cfg, t["cut"])

    zero_counters()
    one_pass()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    (loss, dc, ds, info), ms = timed(one_pass)
    res = dict(t, loss=loss.item(), pass_ms=ms, peak_memory_bytes=torch.cuda.max_memory_allocated(),
               smashed_bytes=info["smashed_bytes"],
               launches={n: fn.launches for n, fn in KERNELS.items()},
               grads_finite=all(bool(torch.isfinite(v).all()) for v in tree_leaves((dc, ds))))
    log(f"[families] (e) {cfg.name} split pass: {json.dumps(res)}")
    fails = []
    if not (math.isfinite(res["loss"]) and res["grads_finite"]) or any(res["launches"].values()):
        fails.append(f"{cfg.name} split pass {res}")
    del params, lc, ls, dc, ds
    torch.cuda.empty_cache()
    return res, fails


def phase_families(dev) -> tuple[dict, list]:
    """Parts (a)-(e) of phase 10; written to build/chip_smoke/families.json."""
    t0 = time.perf_counter()
    res, fails = {"limits": FAMILY_LIMITS}, []
    res["qwen3_full_count_params"] = count_params(get_arch(QWEN))
    res["active_params"] = {a: active_param_count(get_arch(a)) for a in FAMILY_SERVES}
    log(f"[families] count_params (meta device): {QWEN} {res['qwen3_full_count_params']:,} at "
        f"94 layers; active a token {res['active_params']}")
    gen = torch.Generator(device=dev).manual_seed(16)
    res["serves"], res["flash_rows"] = {}, []
    for path, cfg, B, S, new, _ in family_paths():
        # the wgmma flash at the served shape first: group sizes never held before
        window = cfg.sliding_window if "L" in cfg.layer_pattern else 0
        row = attn_row(gen, dev, B, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       torch.bfloat16, window=window, iters=20, path=path, expected="wgmma")
        log(f"[families] (d) {json.dumps(row)}")
        res["flash_rows"].append(row)
        if not row["ok"] or row["variant"] != row["expected"]:
            fails.append(row)
        res["serves"][path], more = family_serve(cfg, dev, B, S, new)
        fails += more
    slots = res["serves"][RGEMMA]["cache_slots"]
    if slots != {"sub_2": get_arch(RGEMMA).sliding_window}:
        fails.append(f"recurrentgemma cache slots {slots}")
    res["lora_rows"], more = serve_lora_rows(dev, family_paths(), 14, "[families] (d)")
    fails += more
    res["decode_splits"], more = decode_split_sweep(dev, family_paths(), 15, "[families] (d)")
    fails += more
    res["smoke"], more = family_smoke(dev)
    fails += more
    res["split"], more = family_split(dev)
    fails += more
    res["fails"], res["seconds"] = fails, time.perf_counter() - t0
    (OUT / "families.json").write_text(json.dumps(res, indent=1, default=str))
    log(f"[families] phase 10 in {res['seconds']:.1f} s")
    if fails:
        raise SystemExit(f"[families] {len(fails)} check(s) failed: {fails}")
    entries = lora_entries(res["lora_rows"], res["serves"], family_paths())
    for row in res["flash_rows"]:
        path = row["path"]
        entries.append(flash_entry(
            f"flash_attention/wgmma-d{row['d']} {path}", "wgmma",
            [dict(row, launches=res["serves"][path]["variants"]["flash_attention"]["wgmma"])],
            row["err"], f"one decode_tokens call of {path}: B={row['B']}, prompt {row['S']}"))
    return res, entries


# ---------------------------------------------------------------------------
# phase 11: the encoder-decoder family (whisper-base) and the vision-language
# family (llava-next-mistral-7b)
# ---------------------------------------------------------------------------

WHISPER, LLAVA = "whisper-base", "llava-next-mistral-7b"
WHISPER_ONE = f"{WHISPER} one-token prompt"
# the serves: arch, batch, prompt tokens, new tokens, patches. whisper: 8
# clips of 30 s (1,500 frames each; batched transcription) and a 32-token
# prompt, and a one-token prompt (the start-of-transcript token alone);
# llava: one anyres image (2,880 patches) and a 1,216-token prompt, 4,096
# positions
ENCDEC_VLM_SERVES = {WHISPER: (WHISPER, 8, 32, NEW, 0), WHISPER_ONE: (WHISPER, 8, 1, NEW, 0),
                     LLAVA: (LLAVA, 2, 1216, NEW, 2880)}
ENCDEC_SPLIT = {"arch": WHISPER, "B": 4, "S": 64, "cut": 1}  # the full-width split pass
# limits, written in PERF.md §6 before the first run on the card (and phase
# 9's: the logits rule, greedy tokens equal but for ties)
ENCDEC_VLM_LIMITS = {
    # the fp32 decode step after the prefill (its cross keys from the cache,
    # at position Tv + S) against the fp32 forward over the appended
    # sequence, of the largest logit: the same function, summed in another order
    "decode_vs_forward": 1e-4,
    "smoke_card_vs_cpu": 1e-4,  # smoke split pass and forward, of the largest value
    "split_vs_monolithic": 2.0 ** -8,  # the full-width split pass, per leaf and loss
}


def stub_inputs(cfg, dev, B, Tv, seed: int) -> dict:
    """The stub frontends' inputs, N(0, 1) from a seeded generator: whisper's
    frame embeddings (B, encoder_seq, D), llava's patch embeddings (B, Tv,
    1024)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "encdec":
        return {"frame_embeds": torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen,
                                            device=dev)}
    return {"vision_embeds": torch.randn((B, Tv, T.VISION_WIDTH), generator=gen, device=dev)}


def stub_batch(cfg, dev, B, S, seed: int) -> dict:
    """A training batch of S positions as the reference's ``launch/specs.py``
    lays one out: Tv = min(vision_tokens, S // 2) patches and S - Tv tokens
    (vlm), the frames (encdec); labels of S positions."""
    Tv = min(cfg.vision_tokens, S // 2) if cfg.family == "vlm" else 0
    batch = TokenStream(B, S, cfg.vocab_size, seed=seed, device=dev).batch_at(0)
    batch["tokens"] = batch["tokens"][:, Tv:]  # labels and mask keep all S positions
    return {**batch, **stub_inputs(cfg, dev, B, Tv, seed)}


def encdec_vlm_paths() -> list[tuple]:
    """Phase 11's serves for serve_lora_rows: (path, cfg, B, positions, new,
    fp32); the one-token prompt's shapes are the main whisper serve's."""
    return [(path, get_arch(arch), B, Tv + S, new, False)
            for path, (arch, B, S, new, Tv) in ENCDEC_VLM_SERVES.items() if path != WHISPER_ONE]


def encdec_vlm_serve(cfg, dev, B, S, new, Tv) -> tuple[dict, list]:
    """One config served through decode_tokens with its stub inputs (the
    counted main path), its prefill and decode timed; then, from the same
    weights, the kernel path's, the plain bf16 path's and fp32's (W +
    scale·A·B unrounded) last-positions prefill logits and one decode step
    (teacher-forced to fp32's token), phase 3's logits rule on both, greedy
    tokens equal but for ties, and the fp32 decode step (at position Tv + S,
    its cross keys from the cache) against the fp32 forward over the
    appended sequence."""
    t0 = time.perf_counter()
    params, lora, prompt = make_model(cfg, dev, B, S)
    inputs = stub_inputs(cfg, dev, B, Tv, seed=3)
    P = Tv + S  # the positions the prefill writes
    tokens, rec = counted_serve(params, cfg, prompt, new, lora, dev, inputs)
    fails = served_fails(cfg, rec, B, P, new)
    log(f"[encdec_vlm] {cfg.name} ({cfg.num_layers} layers, prompt {S}, patches {Tv}): "
        f"decode_tokens {tuple(tokens.shape)} in {rec['seconds']:.2f} s, peak "
        f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB, launches {rec['launches']}, by variant "
        f"{rec['variants']}, flash calls {rec['flash_calls']}")
    errs = {}
    with torch.no_grad():
        cache = T.init_cache(cfg, B, P + new, device=dev)
        out, prefill_ms = timed(lambda: T.prefill(params, {"tokens": prompt, **inputs}, cfg,
                                                  cache, lora=lora))
        del out  # llava's (B, 4096, V) fp32 logits are 1 GB
        tok, step_ms = tokens[:, :1], []
        for pos in range(P, P + new - 1):
            (step, _), ms = timed(lambda: T.decode_step(params, tok, cache, pos, cfg, lora=lora))
            step_ms.append(ms)
            tok = step[:, -1:].argmax(-1)
        del cache
        torch.cuda.empty_cache()
        rec.update(prefill_ms=prefill_ms, decode_step_ms=sum(step_ms) / len(step_ms),
                   decode_tokens_per_s=B / (sum(step_ms) / len(step_ms) / 1e3))
        cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
        exact = tree_map(lambda t: t.to(torch.float32, copy=True), params)
        merge_in_place(exact, lora, cfg32)
        cache = T.init_cache(cfg32, B, P + 1, device=dev)
        ref = prefill_last(exact, prompt, cfg32, cache, kernels=False, inputs=inputs)
        feed = ref[:, -1:].argmax(-1)
        ref_step, _ = T.decode_step(exact, feed, cache, P, cfg32)
        del cache
        fwd = prefill_last(exact, torch.cat([prompt, feed], 1), cfg32, None, kernels=False,
                           last=1, inputs=inputs)
        errs["decode_vs_forward"] = ((ref_step - fwd).abs().max() / fwd.abs().max()).item()
        if not errs["decode_vs_forward"] <= ENCDEC_VLM_LIMITS["decode_vs_forward"]:
            fails.append(f"{cfg.name}: decode vs forward {errs['decode_vs_forward']}")
        del exact, fwd
        torch.cuda.empty_cache()
        cache = T.init_cache(cfg, B, P + 1, device=dev)
        logits = prefill_last(params, prompt, cfg, cache, lora=lora, inputs=inputs)
        step, _ = T.decode_step(params, feed, cache, P, cfg, lora=lora)
        del cache
        merge_in_place(params, lora, cfg)
        cache = T.init_cache(cfg, B, P + 1, device=dev)
        plain = prefill_last(params, prompt, cfg, cache, kernels=False, inputs=inputs)
        plain_step, _ = T.decode_step(params, feed, cache, P, cfg)
        del cache, params, lora
    if not torch.equal(logits[:, -1].argmax(-1), tokens[:, 0]):
        fails.append(f"{cfg.name}: decode_tokens' first token is not the prefill's argmax")
    if not (torch.isfinite(logits).all() and torch.isfinite(step).all()):
        fails.append(f"{cfg.name}: non-finite logits")
    errs.update(prefill_kernel_vs_plain=rel_err(logits, plain),
                decode_kernel_vs_plain=rel_err(step, plain_step),
                prefill_kernel_vs_fp32=rel_err(logits, ref),
                prefill_plain_vs_fp32=rel_err(plain, ref),
                decode_kernel_vs_fp32=rel_err(step, ref_step),
                decode_plain_vs_fp32=rel_err(plain_step, ref_step))
    for stage in ("prefill", "decode"):
        if not errs[f"{stage}_kernel_vs_fp32"] <= max(2 * errs[f"{stage}_plain_vs_fp32"], 1e-3):
            fails.append(f"{cfg.name}: {stage} logits rule {errs}")
    greedy = {"prefill": ties(logits[:, -1], plain[:, -1]),
              "decode": ties(step[:, -1], plain_step[:, -1])}
    if not all(g["ok"] for g in greedy.values()):
        fails.append(f"{cfg.name}: greedy tokens {greedy}")
    rec.update(errors=errs, greedy=greedy, seconds_total=time.perf_counter() - t0,
               layers=cfg.num_layers, B=B, S=S, Tv=Tv, new=new)
    log(f"[encdec_vlm] {cfg.name} (prompt {S}): prefill {prefill_ms:.1f} ms, decode step "
        f"{rec['decode_step_ms']:.2f} ms = {rec['decode_tokens_per_s']:.1f} tokens/s; errors "
        f"{json.dumps(errs)}; greedy {greedy}")
    torch.cuda.empty_cache()
    return rec, fails


def encdec_vlm_smoke(dev) -> tuple[dict, list]:
    """Part (c): each smoke config (fp32) on the card against the CPU, from
    the same weights and batch: a split pass at cut 1 (no kernel) and the
    forward through the kernels' fp32 variants (the CPU's: their plain
    versions)."""
    out, fails = {}, []
    for arch in (WHISPER, LLAVA):
        cfg = smoke_variant(get_arch(arch))
        params, lora, _ = make_model(cfg, torch.device("cpu"), 2, 16)
        lc, ls = split_client_server(lora, 1)
        batch = stub_batch(cfg, torch.device("cpu"), 2, 16 + cfg.vision_tokens, seed=5)
        cpu = split.split_value_and_grad(params, lc, ls, batch, cfg, 1)
        with torch.no_grad():
            cpu_fwd = T.forward(params, batch, cfg, lora=lora)
        zero_counters()
        dp, dlc, dls, db = (to_dev(t, dev) for t in (params, lc, ls, batch))
        card = split.split_value_and_grad(dp, dlc, dls, db, cfg, 1)
        split_launches = {n: fn.launches for n, fn in KERNELS.items()}
        with torch.no_grad():
            card_fwd = T.forward(dp, db, cfg, lora=to_dev(lora, dev))
        gaps = {"loss": abs(card[0].item() - cpu[0].item()) / abs(cpu[0].item()),
                "grads": tree_rel_gap(*([t for t in tree_leaves(g) if t.numel()]
                                        for g in (card[1:3], cpu[1:3]))),
                "forward": ((card_fwd.cpu() - cpu_fwd).abs().max() / cpu_fwd.abs().max()).item(),
                "split_launches": split_launches, "forward_variants": counters()}
        out[arch] = gaps
        log(f"[encdec_vlm] (c) {cfg.name} split pass and forward, card vs CPU: "
            f"{json.dumps(gaps)}")
        want_flash = flash_calls(cfg, 16 + cfg.vision_tokens)
        if not (max(gaps["loss"], gaps["grads"], gaps["forward"])
                <= ENCDEC_VLM_LIMITS["smoke_card_vs_cpu"]
                and not any(split_launches.values())
                and gaps["forward_variants"]["flash_attention"]["fp32"] == want_flash
                and gaps["forward_variants"]["lora_matmul"]["fp32"] > 0):
            fails.append(f"{cfg.name}: smoke card vs CPU {gaps}")
    return out, fails


def encdec_split(dev) -> tuple[dict, list]:
    """Part (c): one split pass of full-width whisper-base (cut 1, B=4, 1,500
    frames, 64 tokens, non-zero B; the client runs the encoder and sends its
    output with the activations) against the monolithic pass and the merged
    model's loss_fn within 2^-8, its time and peak memory; no kernel may
    launch."""
    t = ENCDEC_SPLIT
    cfg = get_arch(t["arch"])
    params = T.init_params(cfg, seed=0, device=dev)
    lora = init_lora(params, cfg, seed=1, device=dev)
    nonzero_b(lora, dev, 4)
    lc, ls = split_client_server(lora, t["cut"])
    batch = stub_batch(cfg, dev, t["B"], t["S"], seed=6)

    def one_pass():
        return split.split_value_and_grad(params, lc, ls, batch, cfg, t["cut"])

    zero_counters()
    one_pass()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    (loss, dc, ds, info), ms = timed(one_pass)
    peak = torch.cuda.max_memory_allocated()
    mloss, mdc, mds = split.monolithic_value_and_grad(params, lc, ls, batch, cfg, t["cut"])
    with torch.no_grad():
        merged_loss, _ = T.loss_fn(merge(params, lora, cfg), batch, cfg)
    res = dict(t, loss=loss.item(), monolithic_loss=mloss.item(), merged_loss=merged_loss.item(),
               pass_ms=ms, peak_memory_bytes=peak, smashed_bytes=info["smashed_bytes"],
               grad_gap=leaf_gap((dc, ds), (mdc, mds)),
               launches={n: fn.launches for n, fn in KERNELS.items()},
               grads_finite=all(bool(torch.isfinite(v).all()) for v in tree_leaves((dc, ds))))
    res["loss_gap"] = max(abs(res["loss"] - res[k]) / abs(res[k])
                          for k in ("monolithic_loss", "merged_loss"))
    log(f"[encdec_vlm] (c) {cfg.name} split pass: {json.dumps(res)}")
    fails = []
    lim = ENCDEC_VLM_LIMITS["split_vs_monolithic"]
    if not (res["loss_gap"] <= lim and res["grad_gap"] <= lim and res["grads_finite"]) \
            or any(res["launches"].values()):
        fails.append(f"{cfg.name} split pass {res}")
    del params, lora, lc, ls, dc, ds, mdc, mds
    torch.cuda.empty_cache()
    return res, fails


def encdec_vlm_flash_rows(dev) -> list[dict]:
    """Part (d): flash (bf16, wgmma) at each attention shape the serves
    launch: whisper's encoder (non-causal, 1,500 x 1,500), its decoder's
    self-attention (causal, 32) and cross-attention (non-causal, 32 x
    1,500); llava's causal GQA 32/8 at d=128 over 4,096 positions."""
    gen = torch.Generator(device=dev).manual_seed(17)
    w, lv = get_arch(WHISPER), get_arch(LLAVA)
    _, Bw, Sw, _, _ = ENCDEC_VLM_SERVES[WHISPER]
    _, Bl, Sl, _, Tv = ENCDEC_VLM_SERVES[LLAVA]
    H, Kv, d = w.num_heads, w.num_kv_heads, w.head_dim
    shapes = [(WHISPER, "encoder", Bw, w.encoder_seq, H, Kv, d, False, None),
              (WHISPER, "self", Bw, Sw, H, Kv, d, True, None),
              (WHISPER, "cross", Bw, Sw, H, Kv, d, False, w.encoder_seq),
              (LLAVA, "self", Bl, Tv + Sl, lv.num_heads, lv.num_kv_heads, lv.head_dim, True,
               None)]
    rows = []
    for path, case, B, S, H, Kv, d, causal, Skv in shapes:
        rows.append(attn_row(gen, dev, B, S, H, Kv, d, torch.bfloat16, iters=20, causal=causal,
                             Skv=Skv, path=path, case=case, expected="wgmma"))
        log(f"[encdec_vlm] (d) {json.dumps(rows[-1])}")
    return rows


def phase_encdec_vlm(dev, smi: str) -> tuple[dict, list]:
    """Parts (a)-(d) of phase 11; written to build/chip_smoke/encdec_vlm.json."""
    t0 = time.perf_counter()
    res, fails = {"nvidia_smi": smi, "limits": ENCDEC_VLM_LIMITS}, []
    res["count_params"] = {a: count_params(get_arch(a)) for a in (WHISPER, LLAVA)}
    log(f"[encdec_vlm] count_params (meta device): {res['count_params']}")
    res["flash_rows"] = encdec_vlm_flash_rows(dev)
    fails += [r for r in res["flash_rows"] if not r["ok"] or r["variant"] != r["expected"]]
    res["serves"] = {}
    for path, (arch, B, S, new, Tv) in ENCDEC_VLM_SERVES.items():
        res["serves"][path], more = encdec_vlm_serve(get_arch(arch), dev, B, S, new, Tv)
        fails += more
    res["lora_rows"], more = serve_lora_rows(dev, encdec_vlm_paths(), 18, "[encdec_vlm] (d)")
    fails += more
    res["smoke"], more = encdec_vlm_smoke(dev)
    fails += more
    res["split"], more = encdec_split(dev)
    fails += more
    res["fails"], res["seconds"] = fails, time.perf_counter() - t0
    (OUT / "encdec_vlm.json").write_text(json.dumps(res, indent=1, default=str))
    log(f"[encdec_vlm] phase 11 in {res['seconds']:.1f} s")
    if fails:
        raise SystemExit(f"[encdec_vlm] {len(fails)} check(s) failed: {fails}")
    return res, encdec_vlm_entries(res)


def encdec_vlm_entries(res) -> list[dict]:
    """The kernels line's entries of phase 11: the LoRA kernel on each serve
    and flash on each (whisper's three attention shapes summed over their
    launches)."""
    entries = lora_entries(res["lora_rows"], res["serves"], encdec_vlm_paths())
    for path, (arch, B, S, new, Tv) in ENCDEC_VLM_SERVES.items():
        if path == WHISPER_ONE:
            continue
        cfg = get_arch(arch)
        rows = [r for r in res["flash_rows"] if r["path"] == path]
        per = {"encoder": cfg.num_encoder_layers, "self": cfg.num_layers,
               "cross": cfg.num_layers}
        entries.append(flash_entry(
            f"flash_attention/wgmma-d{cfg.head_dim} {path}", "wgmma",
            [dict(r, launches=per[r["case"]]) for r in rows], max(r["err"] for r in rows),
            f"one decode_tokens call of {path}: B={B}, prompt {S}"
            + (f" after {Tv} patches" if Tv else f", {cfg.encoder_seq} frames")))
    return entries


# ---------------------------------------------------------------------------
# phase 12: the dry-run's cells measured on the card
# ---------------------------------------------------------------------------

# the measured cells, and what each step must launch (kernel: the variants
# its launches may take; a decode step's LoRA takes ``decode`` at M = b <= 16,
# else ``prefill``); a kernel not named must not launch at all (training runs
# no kernel; decode attention is plain)
SERVE_LORA = {"prefill", "decode"}
DRYRUN_CELLS = {(GEMMA, "prefill_32k"): {"lora_matmul": {"prefill"},
                                         "flash_attention": {"wgmma"}},
                (LLAVA, "decode_32k"): {"lora_matmul": SERVE_LORA},
                (WHISPER, "train_4k"): {},
                (RGEMMA, "long_500k"): {"lora_matmul": {"decode"}}}
# the check cells, composed from M1/M2 and measured whole at a batch that fits
# whole: (arch, shape) -> (b, what each run must launch). At whisper-base x
# prefill_32k the logits are the whole transient at every depth (M2 - M1 = 0),
# so its transient limit holds nothing there; mamba2-130m x train_4k's
# transient grows with depth (the activations saved for the backward pass, 17%
# of it at full depth on an H100), so it holds the transient's composition
DRYRUN_CHECKS = {(WHISPER, "prefill_32k"): (4, {"lora_matmul": {"prefill"},
                                                "flash_attention": {"wgmma"}}),
                 ("mamba2-130m", "train_4k"): (4, {})}
# limits, written in PERF.md §6 before the first run on the card: the
# composed estimate against the full-depth step at the same batch
DRYRUN_LIMITS = {"compose_ms": 0.15, "compose_transient": 0.10}
ALLOWED = {"lora_matmul": {"prefill", "decode"}, "flash_attention": {"wgmma"},
           "ssd_scan": {"wgmma"}}
GEMMA_LORA = {"w_gate/w_up": (3584, 14336, 2), "w_down": (14336, 3584, 1)}  # K, N, a layer


def dryrun_run_fails(name: str, run: dict, expect: dict, cfg, shape) -> list:
    """One measured run's misses: a launch on a variant the serve path must
    not take or the cell does not expect, a kernel the step must launch that
    did not, one it must not that did; the run's resident bytes unlike the
    meta plan's at its depth and batch, or its storages unlike those bytes."""
    out = []
    for kernel, counts in run["launches_total"].items():
        want = expect.get(kernel, set())
        bad = {k: v for k, v in counts.items() if v and not (k in ALLOWED[kernel] and k in want)}
        if bad:
            out.append(f"{name}: {kernel} launched on {bad}, expected {want or 'none'}")
        if want and not sum(run["launches"][kernel].values()):
            out.append(f"{name}: no {kernel} launch in a step")
    plan = dryrun.resident_bytes(cfg.replace(num_layers=run["layers"]),
                                 dryrun.with_batch(shape, run["batch"]))
    if plan != run["resident_bytes"] or sum(plan.values()) != run["storage_bytes"] \
            or run["allocated_bytes"] < run["storage_bytes"]:
        out.append(f"{name}: resident bytes {run['resident_bytes']} (storages "
                   f"{run['storage_bytes']}, allocator {run['allocated_bytes']}) vs plan {plan}")
    return out


def measured_runs(m: dict) -> list[tuple[str, dict]]:
    return [(k, m[k]) for k in ("m1", "m2", "m1t", "full") if k in m]


def dryrun_cell(arch: str, shape_name: str, dev, expect: dict, batch=None,
                full_depth=False) -> tuple[dict, list]:
    """One cell: its plan on the meta device at full depth, then
    ``measure_cell`` on the card, each run held to ``expect``."""
    cfg, shape = get_arch(arch), SHAPES[shape_name]
    t0 = time.perf_counter()
    rec = {"plan": dryrun.plan_cell(cfg, shape)}
    rec["measured"] = m = dryrun.measure_cell(cfg, shape, dev, batch=batch,
                                              full_depth=full_depth)
    fails = [] if m["fits"] else [f"{arch} x {shape_name}: {m.get('error') or m['reason']}"]
    for name, run in measured_runs(m):
        fails += dryrun_run_fails(f"{arch} x {shape_name} {name}", run, expect, cfg, shape)
    rec["seconds"] = time.perf_counter() - t0
    brief = {k: {"layers": r["layers"], "b": r["batch"], "ms": r["ms"],
                 "transient_GB": r["transient_bytes"] / 1e9,
                 "resident_GB": r["resident_total"] / 1e9,
                 "launches": {n: {v: c for v, c in by.items() if c}
                              for n, by in r["launches"].items()}}
             for k, r in measured_runs(m)}
    log(f"[dryrun] {arch} x {shape_name}: plan flops {rec['plan']['flops']:.4g} (model "
        f"{rec['plan']['model_flops']:.4g}), resident {rec['plan']['resident_total'] / 1e9:.2f} "
        f"GB at B={shape.global_batch}; b={m.get('b')}; runs {json.dumps(brief)}; composed "
        f"{json.dumps(m.get('composed'))}; at the global batch "
        f"{json.dumps(m.get('at_global_batch'))}; {rec['seconds']:.1f} s")
    return rec, fails


def row_ulps(o, ref, n: float = 2.0) -> tuple[float, int]:
    """Each query row's largest |o - ref| over n bf16 ulps (2^-7 relative)
    of that row's largest |ref|: the worst row's ratio and the rows over 1.
    A row that attends over N keys has outputs of about sqrt(e/N), so a
    tolerance from the largest output of all rows (the first row's) would
    pass a kernel that drops keys from the long rows."""
    ref = ref.float()
    ratio = (o.float() - ref).abs().amax(-1) / (n * 2.0 ** -7 * ref.abs().amax(-1))
    return ratio.max().item(), int((ratio > 1).sum().item())


def planted_windows(S: int, window: int) -> dict:
    """Faults the per-row check must catch, planted as the kernel's window
    moved by one 64-key tile: global, the first tile dropped from the last
    64 rows (window S - 64); windowed, the window 64 keys too wide or too
    narrow."""
    if not window:
        return {"first tile dropped from the last rows": S - 64}
    return {"window + 64": window + 64, "window - 64": window - 64}


def causal_pairs(S: int, window: int) -> int:
    """Score entries a causal (windowed) attention over S positions needs."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def long_flash_row(gen, dev, B, S, H, Kv, d, window, softcap, **meta) -> dict:
    """Flash (bf16, causal) at a 32k prefill's shape against the plain fp32
    version in query chunks, each query row within 2 bf16 ulps of its own
    largest output (``row_ulps``), and each planted fault (``planted_windows``)
    caught; with event, device, plain (chunked) and library times (SDPA
    without the softcap; a window as its boolean mask) and the bound."""
    nbytes = 2 * (2 * B * H * S * d + 2 * B * Kv * S * d)
    ops = 4 * B * H * causal_pairs(S, window) * d
    sets = [attn_inputs(gen, B, S, H, Kv, d, dev) for _ in range(2)]
    call = lambda q, k, v: flash_attention(q, k, v, causal=True, window=window,  # noqa: E731
                                           softcap=softcap)
    plain = lambda q, k, v: flash_attention_fp32(q, k, v, causal=True,  # noqa: E731
                                                 window=window, softcap=softcap, q_chunk=1024)
    o = call(*sets[0])
    torch.cuda.synchronize()
    ref = plain(*sets[0])
    err = (o.float() - ref).abs().max().item()
    worst, over = row_ulps(o, ref)
    planted = {}
    for name, w in planted_windows(S, window).items():
        bad = flash_attention(*sets[0], causal=True, window=w, softcap=softcap)
        f_worst, f_over = row_ulps(bad, ref)
        planted[name] = {"window": w, "worst_row_ulps_ratio": f_worst, "rows_over": f_over}
        del bad
    del o, ref
    mask = None
    if window:
        i = torch.arange(S, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    lib = lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, is_causal=mask is None, enable_gqa=True)
    b_ms, b_by = bound_ms(nbytes, ops)
    row = dict(kernel="flash_attention", dtype="bfloat16", B=B, S=S, H=H, Kv=Kv, d=d,
               window=window, softcap=softcap, **meta,
               variant=ran_variant("flash_attention", lambda: call(*sets[0])),
               err=err, worst_row_ulps_ratio=worst, rows_over=over, planted=planted,
               ok=worst <= 1 and all(f["rows_over"] for f in planted.values()),
               ms=time_ms(call, sets, 4),
               **device_time_ms(call, sets, 4, bound=b_ms), plain_ms=time_ms(plain, sets, 1),
               library_ms=time_ms(lib, sets, 4),
               **library(device_time_ms(lib, sets, 4, bound=b_ms)), bound_ms=b_ms,
               bound_by=b_by)
    row["bound_share"] = b_ms / row["device_ms"]
    del sets, mask
    torch.cuda.empty_cache()
    return row


def dryrun_kernel_rows(dev, b: int) -> tuple[list, list]:
    """Flash at gemma2-9b's 32k prefill (global and windowed 4096, softcap
    50) and the LoRA kernel at its widest products at M = b x 32,768, each
    against its plain version."""
    cfg = get_arch(GEMMA)
    gen = torch.Generator(device=dev).manual_seed(19)
    S, r = SHAPES["prefill_32k"].seq_len, (cfg.lora or LoRAConfig()).rank
    flash = [long_flash_row(gen, dev, b, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                            window, cfg.attn_logit_softcap, case=case)
             for case, window in (("global", 0), ("windowed", cfg.sliding_window))]
    scale = (cfg.lora or LoRAConfig()).scale
    lora = [lora_row(gen, dev, b * S, K, N, r, torch.bfloat16, scale, iters=10,
                     device_iters=5, case=case, per_layer=n)
            for case, (K, N, n) in GEMMA_LORA.items()]
    torch.cuda.empty_cache()
    rows = flash + lora
    for row in rows:
        log(f"[dryrun] 32k row {json.dumps(row)}")
    fails = [r for r in flash if not r["ok"] or r["variant"] != "wgmma"]
    fails += [r for r in lora if not r["err"] <= r["tol"] or r["variant"] != "prefill"]
    return rows, fails


def phase_dryrun(dev, smi: str) -> tuple[dict, list]:
    """Phase 12: ``launch/dryrun.py``'s cells planned on the meta device and
    measured on the card (M1, M2, M1t; composed and scaled), each run's
    launches by variant and resident bytes held; the check cells composed
    and measured whole at one batch; flash and LoRA at gemma2-9b's 32k shapes
    against their plain versions. Written to build/chip_smoke/dryrun.json."""
    t0 = time.perf_counter()
    res, fails = {"nvidia_smi": smi, "limits": DRYRUN_LIMITS, "cells": {}}, []
    for (arch, shape_name), expect in DRYRUN_CELLS.items():
        res["cells"][f"{arch} {shape_name}"], more = dryrun_cell(arch, shape_name, dev, expect)
        fails += more
    res["checks"] = {}
    for (arch, shape_name), (b, expect) in DRYRUN_CHECKS.items():
        # read in this process too, after its garbage and the allocator's
        # cache are freed: recorded beside the fresh process's reading, which
        # the limits judge (``fresh_check_cell``)
        gc.collect()
        torch.cuda.empty_cache()
        here, more = dryrun_cell(arch, shape_name, dev, expect, batch=b, full_depth=True)
        fails += more
        m = here["measured"]
        in_process = {"compose_vs_full": m.get("compose_vs_full"),
                      "composed_ms": m.get("composed", {}).get("ms"),
                      "full_ms": m.get("full", {}).get("ms")}
        log(f"[dryrun] check {arch} x {shape_name} in this process: {json.dumps(in_process)}")
        del here
        gc.collect()
        torch.cuda.empty_cache()  # the check cell's process shares the card
        check, more = fresh_check_cell(arch, shape_name, b)
        fails += more
        if check is None:
            continue
        check["in_process"] = in_process
        m, c = check["measured"], check["measured"]["composed"]
        gaps = m["compose_vs_full"]
        # the share of the composed transient that the depth composes: 0 where
        # the check cannot test the transient's composition
        depth_share = get_arch(arch).num_groups * c["transient_bytes_per_group"] \
            / c["transient_bytes"]
        check.update(compose_vs_full=gaps, transient_depth_share=depth_share)
        res["checks"][f"{arch} {shape_name}"] = check
        log(f"[dryrun] check {arch} x {shape_name} at b={b}, depth {m['full']['layers']}: "
            f"composed {c['ms']:.2f} ms, {c['transient_bytes'] / 1e9:.3f} GB (depth's share "
            f"{depth_share:.3f}) vs measured {m['full']['ms']:.2f} ms, "
            f"{m['full']['transient_bytes'] / 1e9:.3f} GB: {json.dumps(gaps)}")
        if not (abs(gaps["ms"]) <= DRYRUN_LIMITS["compose_ms"]
                and abs(gaps["transient"]) <= DRYRUN_LIMITS["compose_transient"]):
            fails.append(f"check cell {arch} x {shape_name}: composed vs measured {gaps}")
    gemma = res["cells"][f"{GEMMA} prefill_32k"]["measured"]
    res["kernel_rows"], more = dryrun_kernel_rows(dev, gemma["b"])
    fails += more
    res["fails"], res["seconds"] = fails, time.perf_counter() - t0
    (OUT / "dryrun.json").write_text(json.dumps(res, indent=1, default=str))
    log(f"[dryrun] phase 12 in {res['seconds']:.1f} s")
    if fails:
        raise SystemExit(f"[dryrun] {len(fails)} check(s) failed: {fails}")
    return res, dryrun_entries(res)


def fresh_check_cell(arch: str, shape_name: str, b: int) -> tuple[dict | None, list]:
    """``dryrun_cell`` of a check cell (composed and measured whole) in a
    process of its own, as the dry-run CLI measures it: after this process's
    phases 1-11, mamba2-130m x train_4k's full-depth step alone ran 20-28%
    slower in 2 of 3 runs on an H100 (M1 and M2 unchanged; composed vs full
    −15.1%), while four fresh processes read within 0.6% (PERF.md §7). The
    cause is not known; ``phase_dryrun`` keeps this process's reading beside
    the fresh one, so the gap stays in the record."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--check-cell", arch,
                           shape_name, str(b)], capture_output=True, text=True, timeout=1200)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if proc.returncode != 0 or not lines:
        return None, [f"check cell {arch} x {shape_name}: its process exited {proc.returncode}: "
                      + proc.stderr[-2000:]]
    out = json.loads(lines[-1])
    return out["rec"], out["fails"]


def check_cell_main(arch: str, shape_name: str, b: str) -> int:
    """The process of ``fresh_check_cell``: its record and failures as the
    last line of its standard output."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec, fails = dryrun_cell(arch, shape_name, torch.device("cuda", 0),
                             DRYRUN_CHECKS[(arch, shape_name)][1], batch=int(b), full_depth=True)
    print(json.dumps({"rec": rec, "fails": fails}, default=str))
    return 0


def dryrun_entries(res) -> list[dict]:
    """The kernels line's 32k rows: flash (global, windowed) and LoRA (its
    two widest products) at gemma2-9b x prefill_32k, their launches those of
    the cell's measured runs (every call counted; an LG layer launches one
    global and one windowed flash, and seven LoRA products, of which the
    two shapes are 2 and 1)."""
    m = res["cells"][f"{GEMMA} prefill_32k"]["measured"]
    runs = [r for _, r in measured_runs(m)]
    layer_steps = sum(r["calls"] * r["layers"] for r in runs)
    flash_n = sum(r["launches_total"]["flash_attention"]["wgmma"] for r in runs)
    lora_n = sum(r["launches_total"]["lora_matmul"]["prefill"] for r in runs)
    assert flash_n == layer_steps and lora_n == 7 * layer_steps, (flash_n, lora_n, layer_steps)
    per = f"{GEMMA} x prefill_32k measured: b={m['b']}, S=32,768, depths {m['depths']}"
    out = []
    for row in res["kernel_rows"]:
        if row["kernel"] == "flash_attention":
            out.append(flash_entry(f"flash_attention/wgmma-d256 {GEMMA} prefill_32k "
                                   f"{row['case']}", "wgmma",
                                   [dict(row, launches=layer_steps // 2)], row["err"], per))
            continue
        n = layer_steps * row["per_layer"]
        total = {k: row[k] * n for k in ("ms", "device_ms", "graph_ms", "plain_ms", "bound_ms",
                                         "library_ms", "library_device_ms")}
        out.append({"name": f"lora_matmul/prefill {GEMMA} prefill_32k {row['case']}",
                    "route": "cuda", "source": "src/repro_torch/csrc/lora_matmul.cu",
                    "replaces": "src/repro/kernels/lora_matmul.py:51",
                    "variants": {"prefill": n}, "launches": n, "max_abs_err": row["err"],
                    **total, "bound_by": row["bound_by"],
                    "library": "addmm(x·W, x·A, B, alpha=scale)",
                    "per": f"{per}; M={row['M']} K={row['K']} N={row['N']}"})
    return out


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--check-cell"]:
        return check_cell_main(*sys.argv[2:5])
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    build = phase_build()
    results = {arch: run_path(arch, dev) for arch in ARCHS}
    kernels = kernel_entries(results)
    wide = {name: run_wide(name, cfg, dev) for name, cfg in wide_configs().items()}
    train, ctx = phase_train(dev)
    priced = phase_priced(dev, ctx)
    del ctx
    campaign = phase_campaign(dev)
    cli, rows = phase_cli(dev)
    kernels += variant_entries(rows) + rank_entries(cli) + next_entries(cli, wide)
    dense, more = phase_dense(dev)
    kernels += more
    families, more = phase_families(dev)
    kernels += more
    encdec_vlm, more = phase_encdec_vlm(dev, smi)
    kernels += more
    dry, more = phase_dryrun(dev, smi)
    kernels += more
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "build": build, "kernels": kernels, "traces": TRACE_LOG,
         "paths": {arch: {"checks": r["checks"], "slice": r["slice"],
                          "end_to_end": r["timings"]["end_to_end"]}
                   for arch, r in results.items()}, "wide": wide, "train": train,
         "priced": priced,
         "campaign": campaign, "cli": cli,
         "dense": {k: dense[k] for k in ("gemma2", "gemma2_rule", "serves", "train")},
         "families": {k: families[k] for k in ("serves", "smoke", "split")},
         "encdec_vlm": {k: encdec_vlm[k] for k in ("serves", "smoke", "split")},
         "dryrun": {k: dry[k] for k in ("cells", "checks", "seconds")}},
        indent=1, default=str))
    log(f"[timing] torch.profiler traces kept {TRACE_LOG['kept']}, lost {TRACE_LOG['lost']}")
    log(f"[done] chip_smoke in {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "shapes"}
                                  for e in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
