#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Two serving paths, each at full width and depth: ``fedsllm-100m`` (dense,
fused LoRA + flash attention) and ``mamba2-130m`` (SSM, fused LoRA + the SSD
chunked scan); then the training path, one FedsLLM global round. Phases,
each of which fails the run (non-zero exit) on any miss:
  1. build   — compile every CUDA kernel from ``src/repro_torch/csrc`` (one
               nvcc per source, all at once);
then, for each serving path:
  2. kernels — each of its kernels against its plain PyTorch version on the
               card at the path's shapes, with stated tolerances;
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
               (``device_ms``; the graph's time where the profiler keeps
               losing kernel records, as ``device_ms_by`` says) of each
               kernel, its plain version and one library call (where one
               exists) at the path's shapes, beside
               the least time the card could take and the first port's time
               for the same kernel, and the host's cost of a LoRA launch (``host_ms``);
               prefill ms and decode tokens/s;
and last
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
               launch in the phase; round seconds, ms per pass, peak memory.

Prints the compiled kernels' registers and spills, the card's name and power
limit, a ``{"kernels": [...]}`` line, and last ``{"ok": true, "device":
{...}}``. Details go to ``build/chip_smoke/``.
Without a CUDA card it exits non-zero before printing any result.
"""

from __future__ import annotations

import collections
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api.aggregators import get_aggregator  # noqa: E402
from repro_torch.api.allocators import get_allocator  # noqa: E402
from repro_torch.config import FedsLLMConfig, LoRAConfig, get_arch, smoke_variant  # noqa: E402
from repro_torch.core import federated, fedsllm, split  # noqa: E402
from repro_torch.core.delay_model import sample_network  # noqa: E402
from repro_torch.core.lora import init_lora, merge  # noqa: E402
from repro_torch.data.tokens import TokenStream, client_batches  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attn_ops import flash_attention  # noqa: E402
from repro_torch.kernels.attn_ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.lora_ops import lora_matmul  # noqa: E402
from repro_torch.kernels.lora_ref import lora_matmul_ref  # noqa: E402
from repro_torch.kernels.ssd_ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.net.topology import get_topology  # noqa: E402
from repro_torch.serving.decode import decode_tokens  # noqa: E402
from repro_torch.sim.scenario import get_scenario  # noqa: E402
from repro_torch.tree import (tree_index, tree_leaves, tree_map, tree_rel_gap,  # noqa: E402
                              tree_stack)

OUT = ROOT / "build" / "chip_smoke"
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, HBM3 bandwidth
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
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
# kernel and (M, K, N)
EARLIER_US = {
    ("lora_matmul", 4096, 768, 768): 93.3, ("lora_matmul", 4096, 768, 256): 74.5,
    ("lora_matmul", 4096, 768, 2048): 221.2, ("lora_matmul", 4096, 2048, 768): 218.4,
    ("lora_matmul", 8, 768, 768): 63.8, ("lora_matmul", 8, 768, 256): 62.9,
    ("lora_matmul", 8, 768, 2048): 63.5, ("lora_matmul", 8, 2048, 768): 160.3,
    ("lora_matmul", 4096, 768, 3352): 325.3, ("lora_matmul", 4096, 1536, 768): 169.3,
    ("lora_matmul", 8, 768, 3352): 63.6, ("lora_matmul", 8, 1536, 768): 122.1,
    ("flash_attention",): 140.2, ("ssd_scan",): 485.1,
}
DECODE_TARGET_MS = 0.010  # the decode LoRA's device-time target per launch


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bf16_ulps(ref, n: float = 2.0) -> float:
    """n bf16 ulps (2^-7 relative) of the largest output."""
    return n * 2.0 ** -7 * ref.float().abs().max().item()


TRACES = 2  # torch.profiler traces taken before a lossy one is given up
TRACE_LOG = collections.Counter()  # traces kept / lost, for the summary
TRACE_PAD_S = 0.1  # idle host time at each end of a trace's window


def trace(fn):
    """The CUDA kernel and host op records of one torch.profiler trace of fn().
    The profiler may drop a kernel whose device timestamps fall outside the
    trace's window on the host's clock; the idle pad at each end keeps a
    small offset between the two clocks from dropping the first or last
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    events = prof.key_averages()
    return ([e for e in events if e.device_type == DeviceType.CUDA],
            [e for e in events if e.device_type == DeviceType.CPU])


def port_launches() -> int:
    return sum(fn.launches for fn in KERNELS.values())


def device_ms(fn) -> tuple[float | None, list, list]:
    """Device time of the CUDA kernels one call of fn runs (torch.profiler),
    the kernels that take most of it, and the host ops that take most host
    time. A trace with fewer kernel records than the port's kernels launched
    in it (their counters say how many) lost records: it is taken again, and
    after TRACES lossy traces the device time is None (not measured)."""
    for _ in range(TRACES):
        before = port_launches()
        kernels, host = trace(fn)
        launched = port_launches() - before
        recorded = sum(e.count for e in kernels)
        if kernels and recorded >= launched:
            TRACE_LOG["kept"] += 1
            kernels.sort(key=lambda e: -e.self_device_time_total)
            host.sort(key=lambda e: -e.self_cpu_time_total)
            total = sum(e.self_device_time_total for e in kernels) / 1e3
            return (total,
                    [(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in kernels[:10]],
                    [(e.key[:90], e.self_cpu_time_total / 1e3, e.count) for e in host[:10]])
        TRACE_LOG["lost"] += 1
        log(f"[timing] torch.profiler recorded {recorded} kernels where the port alone "
            f"launched {launched}: a lossy trace")
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


def device_time_ms(fn, arg_sets, iters: int = 30) -> dict:
    """Mean device time per call of fn(*args), two ways: ``graph_ms`` (CUDA
    graph replay, always taken) and the CUDA kernels' time in a torch.profiler
    trace of `iters` calls cycling through `arg_sets`. Every call launches its
    main kernel once, so a trace whose most recorded kernel has fewer than
    `iters` records is lossy: it is taken again, and after TRACES lossy
    traces ``device_ms`` is the graph's time. ``device_ms_by`` says which."""
    out = {"graph_ms": graph_ms(fn, arg_sets, iters)}
    for _ in range(TRACES):
        kernels, _ = trace(lambda: [fn(*arg_sets[i % len(arg_sets)]) for i in range(iters)])
        recorded = max((e.count for e in kernels), default=0)
        if recorded >= iters:
            TRACE_LOG["kept"] += 1
            total = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
            return {"device_ms": total, "device_ms_by": "profiler", **out}
        TRACE_LOG["lost"] += 1
        log(f"[timing] torch.profiler recorded {recorded} of {iters} launches: a lossy trace")
    return {"device_ms": out["graph_ms"], "device_ms_by": "cuda_graph", **out}


def share(part: float | None, whole: float) -> float | None:
    return None if part is None else part / whole


def library(times: dict | None) -> dict:
    """A library call's device times (from device_time_ms) under the row's
    ``library_`` keys, all None where no library call computes the function."""
    keys = ("device_ms", "device_ms_by", "graph_ms")
    return {f"library_{k}": None if times is None else times[k] for k in keys}


def judge(row: dict) -> dict:
    """The row's verdicts: floor (event time at most half its earlier time,
    which was event-timed too; and the same for the device time, which the
    host's launch cost does not hide), target (device time no slower than
    the library call's, or at most 10 µs at decode), and its device time's
    share of the bound."""
    key = (row["kernel"], row["M"], row["K"], row["N"]) if row["kernel"] == "lora_matmul" \
        else (row["kernel"],)
    earlier = EARLIER_US.get(key)
    row["earlier_ms"] = earlier / 1e3 if earlier else None
    row["floor_met"] = None if earlier is None else row["ms"] <= earlier / 2e3
    row["floor_met_device"] = None if earlier is None else row["device_ms"] <= earlier / 2e3
    row["bound_share"] = row["bound_ms"] / row["device_ms"]
    if row.get("variant") == "decode":
        row["target"], row["target_met"] = "device_ms <= 0.010", row["device_ms"] <= DECODE_TARGET_MS
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


def lora_shapes(cfg) -> collections.Counter:
    """(K, N) of each adapted projection of one layer, with its count."""
    D, F = cfg.d_model, cfg.d_ff
    if cfg.layer_pattern == "M":  # in_proj, out_proj
        d_inner, H, P, N, conv_ch = M2.dims(cfg)
        return collections.Counter([(D, 2 * d_inner + 2 * N + H), (d_inner, D)])
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return collections.Counter([(D, q), (D, kv), (D, kv), (q, D), (D, F), (D, F), (F, D)])


def path_variants(cfg) -> dict[str, dict[str, int]]:
    """Launches of each variant in one decode_tokens call: the prefill's LoRA
    products (M = B·S) through the prefill variant, the decode steps' (M = B)
    through the decode variant, flash and the SSD scan (one per layer of the
    prefill) through their wgmma variants; none through the first port's
    kernels."""
    per_forward = sum(lora_shapes(cfg).values()) * cfg.num_layers
    ssm = cfg.layer_pattern == "M"
    return {"lora_matmul": {"prefill": per_forward, "decode": per_forward * (NEW - 1),
                            "generic": 0},
            "flash_attention": {"wgmma": 0 if ssm else cfg.num_layers, "wmma": 0},
            "ssd_scan": {"wgmma": cfg.num_layers if ssm else 0, "fma": 0}}


def path_kernels(cfg) -> dict[str, int]:
    """Launches of each kernel in one decode_tokens call (prefill + NEW-1 steps)."""
    per_forward = sum(lora_shapes(cfg).values()) * cfg.num_layers
    ssm = cfg.layer_pattern == "M"
    return {"lora_matmul": per_forward * NEW,
            "flash_attention": 0 if ssm else cfg.num_layers,  # one per layer of the prefill
            "ssd_scan": cfg.num_layers if ssm else 0}


def lora_inputs(gen, M, K, N, r, dev):
    x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    w, a, b = (torch.randn(s, generator=gen, device=dev).mul(0.05).bfloat16()
               for s in ((K, N), (K, r), (r, N)))
    return x, w, a, b


def lora_work(M, K, N, r):
    nbytes = 2 * (M * K + K * N + K * r + r * N + M * N)
    ops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N
    return nbytes, ops


def attn_inputs(gen, B, S, H, Kv, d, dev):
    """q, k, v in the model's (B, S, heads, d) layout, as (B, heads, S, d) views."""
    q = torch.randn((B, S, H, d), generator=gen, device=dev).bfloat16().transpose(1, 2)
    k, v = (torch.randn((B, S, Kv, d), generator=gen, device=dev).bfloat16().transpose(1, 2)
            for _ in range(2))
    return q, k, v


def attn_work(B, S, H, Kv, d, causal, window):
    qpos = torch.arange(S)[:, None]
    kpos = torch.arange(S)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    pairs = int(mask.sum())  # score entries this input needs
    nbytes = 2 * (2 * B * H * S * d + 2 * B * Kv * S * d)
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


def ssd_work(B, S, H, P, N, chunk, esize, h0):
    """Bytes: x, dt, A, Bm, Cm read once, y (fp32) and the final state written
    once, the initial state read once if given. Operations: the chunked
    algorithm at the reference's chunk Q (scores C·Bᵀ and their product with
    dt·x, 2·Q²·(N+P) per chunk; the state's contribution and update,
    4·Q·N·P), per (b, h)."""
    nbytes = (esize * (B * S * H * P + 2 * B * S * N) + 4 * (B * S * H + H)
              + 4 * B * S * H * P + 4 * B * H * P * N * (2 if h0 else 1))
    Q = min(chunk, S)
    ops = B * H * math.ceil(S / Q) * (2 * Q * Q * (N + P) + 4 * Q * N * P)
    return nbytes, ops


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
    return fails


def ssd_checks(cfg, dev, gen, rows, errs) -> list:
    """y and the final state against the sequential recurrence, at the path's
    widths: the full prompt, a ragged S, an initial state, 8 reference
    chunks, in fp32 (the fma variant) and in bf16 (the wgmma variant), and
    the prefill's own bf16 strided views of the conv output. Tolerance 1e-4
    of the largest reference output, the reference's own
    (tests/test_kernels.py): fma's products are fp32 FMAs, wgmma's take its
    fp32 operands (decayed scores, state, w·x) as two bf16 terms each; both
    sum in another order (and exp(cs_q − cs_s) stands for a product of
    per-step decays)."""
    fails = []
    errs["ssd_scan"] = 0.0
    _, H, P, N, _ = M2.dims(cfg)
    cases = [(S, h0, dtype, expected)
             for dtype, expected in ((torch.float32, "fma"), (torch.bfloat16, "wgmma"))
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


def make_model(cfg, dev):
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
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
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
    last_err = (logits[:, -1] - plain[:, -1]).abs().max().item()
    # greedy tokens equal, except a row whose plain top-2 gap is within the
    # two paths' measured logit error (a tie at this precision)
    top2 = plain[:, -1].topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1])
    same = tok == plain_tok
    tie = (~same) & (gap <= 2 * last_err)
    log(f"[slice] {cfg.name}: logits relative errors " + json.dumps(errs))
    log(f"[slice] first-step greedy tokens equal on {int(same.sum())}/{BATCH} rows, "
        f"{int(tie.sum())} tie(s) within {2 * last_err:.3e}")
    # the kernel path may be no further from fp32 than twice the plain bf16
    # path is (both round to bf16, at different places), or 1e-3 where the
    # working type is fp32 itself
    for stage in ("prefill", "decode"):
        floor = max(2 * errs[f"{stage}_plain_vs_fp32"], 1e-3)
        assert errs[f"{stage}_kernel_vs_fp32"] <= floor, errs
    assert bool((same | tie).all()), (tok.tolist(), plain_tok.tolist(), gap.tolist())
    return {"launches": launches, "variants": variants, "serve_first_call_s": serve_s,
            "errors": errs,
            "tokens_equal": int(same.sum()), "ties": int(tie.sum())}


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
                kernel="lora_matmul", M=M, K=K, N=N, r=r,
                variant=ran_variant("lora_matmul", lambda: lora_call(*sets[0])),
                launches=n * calls_per_layer * cfg.num_layers,
                ms=time_ms(lora_call, sets, 200), **device_time_ms(lora_call, sets),
                host_ms=host_ms(lora_call, sets),
                plain_ms=time_ms(lora_plain, sets, 50),
                library_ms=time_ms(lora_library, sets, 200),
                **library(device_time_ms(lora_library, sets)),
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
        ms=time_ms(call, sets, 100), **device_time_ms(call, sets),
        plain_ms=time_ms(lambda q, k, v: flash_attention_ref(q, k, v, causal=True), sets, 20),
        library_ms=time_ms(sdpa, sets, 100), **library(device_time_ms(sdpa, sets)),
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
    nbytes, ops = ssd_work(BATCH, PROMPT, H, P, N, cfg.ssm_chunk, 2, True)
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
        ms=time_ms(call, sets, 50), **device_time_ms(call, sets, 10),
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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
    train, ctx = phase_train(dev)
    priced = phase_priced(dev, ctx)
    del ctx
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "build": build, "kernels": kernels, "traces": TRACE_LOG,
         "paths": {arch: {"checks": r["checks"], "slice": r["slice"],
                          "end_to_end": r["timings"]["end_to_end"]}
                   for arch, r in results.items()}, "train": train, "priced": priced},
        indent=1))
    log(f"[timing] torch.profiler traces kept {TRACE_LOG['kept']}, lost {TRACE_LOG['lost']}")
    print(smi)
    print(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "shapes"}
                                  for e in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
