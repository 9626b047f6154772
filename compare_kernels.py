#!/usr/bin/env python3
"""Time the serving paths' kernels of two checkouts in turns on one CUDA card.

    python3 compare_kernels.py OTHER_CHECKOUT

OTHER_CHECKOUT is the root of another checkout of this repository, e.g. the
parent commit unpacked into a git-ignored directory with
``git archive HEAD~1 | tar -x -C build/parent``. Each side runs in a process
of its own that imports that side's ``repro_torch`` and builds that side's
kernels; the sides take turns, other, this, this, other, so that a drift of
the card's clocks shows. Each run prints the CUDA-graph device time (ms a
call) of flash attention at fedsllm-100m's prefill (B=8, S=512, 12 heads over
4, d=64; with and without a softcap of 50), phi4-mini's (24 heads over 8,
d=128) and gemma2-9b's (B=2, S=8192, 16 heads over 8, d=256, softcap 50;
global and windowed to 4096) and of the LoRA kernel at
fedsllm-100m's prefill (M=4096) and decode (M=8) shapes and at the dense
family's large decode shapes (rank 16), at fedsllm-100m's shapes at rank 128
and at a few shapes at ranks 4, 100, 128, 256 and 512 up to mistral-7b's
w_gate (K=4096, N=14336), at the shapes a tensor map cannot read (x one
element off 16 bytes, K or N not a multiple of 8: tiles copied by the
producers), in fp32 (TF32 off) at fedsllm-100m's shapes (ranks 16, 80 and
128) and gemma2-9b's decode MLP (M=2), flash attention in fp32 at the
same rows and the smoke serve's (B=4, S=32, d=16), and the host's
time a call at fedsllm-100m's decode shapes; at the fp32 smoke serves'
shapes (``launch.serve --smoke``: B=4, prompt 32, 16 new tokens) also the
host's time and the event time a call (back-to-back calls between two
events, as ``chip_smoke.py`` times a row), and both summed over the 288
launches of the two smoke serves; then the rows of the first port's last
two variants' designs (``NEXT``): bf16 flash at head dims 16 and 32 (B=8,
S=512, 12 heads over 4) and with q one element off 16 bytes at d=64 (the
same heads), d=128 (24 over 8) and d=256 (B=2, S=2048, 16 over 8), and the
SSD scan in fp32 at mamba2-130m's widths (B=8, S=512, 24 heads of 64,
N=128) and at the smoke serve's shape (B=4, S=32, 8 heads of 16, N=16), and
in bf16 at mamba2-130m's widths; then (``LAST``) bf16 flash at head dims
between the compiled widths, 48 and 96 (B=8, S=512, 12 heads over 4), and
the SSD scan in bf16 above N=256 (B=2, S=512, 4 heads of 64, N=320 and
1024), each on a side whose wrapper takes it (a side that raises for it
leaves the row out). The last line holds each
metric's least time on each side and their ratio (this / other; none
where only this side measured it).

    python3 compare_kernels.py OTHER_CHECKOUT --host

imports both sides' ``repro_torch`` into one process and calls their public
LoRA wrapper in turns at the fp32 smoke serves' shapes, blocks of calls
alternating between the sides, so that the host's drift between processes
cancels: each side's median host and event ms a call, and both summed over
the 288 launches; then their flash attention at the fp32 smoke serve's
shape (B=4, S=32, 4 heads over 2, d=16; 2 launches a serve) the same way.

    python3 compare_kernels.py --sweep

times the choices of this checkout's LoRA rule against their alternatives
(graph and event ms a call; one JSON line each): the fp32 prefill in one
launch or two at rank 16 (``FP32_TWO_LAUNCH_WORK``), the fp32 decode
reading W by TMA or by cp.async (the rule takes TMA wherever it can), the
bf16 prefill's tile width at ranks 17-63 not a multiple of 8 (A
copied; ``prefill_tile_n``), and the bf16 prefill and decode with x's or
W's tiles copied by the producers (a view one element off 16 bytes)
against the same values read by TMA.

    python3 compare_kernels.py --ptxas

builds this checkout's ``csrc/flash_attention.cu`` twice, as it is served
and with ``-DREPRO_FLASH_FULL_ONLY`` (the copying producers' FULL loops
alone, no loop for a padded head dim), and prints ptxas's registers and
spills of each kernel instance in both builds (one JSON line each): what
the served instances' loop costs, which the served build's one figure per
kernel cannot tell apart from the padded loop's.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# B, S, H, Kv, d, window, softcap: fedsllm-100m's prefill, phi4-mini's, gemma2-9b's
FLASH = [(8, 512, 12, 4, 64, 0, 0.0), (8, 512, 12, 4, 64, 0, 50.0), (8, 512, 24, 8, 128, 0, 0.0),
         (2, 8192, 16, 8, 256, 0, 50.0), (2, 8192, 16, 8, 256, 4096, 50.0)]
# the same in fp32 (the fp32 variant), with chip_smoke.py's fp32 rows: B=2,
# 8/2 heads at d=128, fedsllm-100m's with a window of 128, the smoke serve's
FLASH_FP32 = FLASH + [(2, 512, 8, 2, 128, 0, 0.0), (8, 512, 12, 4, 64, 128, 0.0),
                      (4, 32, 4, 2, 16, 0, 0.0)]
# bf16 LoRA where a tensor map cannot read an operand (M, K, N, r, x one
# element off 16 bytes): chip_smoke.py's misaligned rows, K % 8 and N % 8
COPIED = [(4096, 768, 2048, 16, True), (8, 768, 768, 16, True), (8, 772, 768, 16, False),
          (4096, 772, 768, 16, False), (8, 768, 300, 16, False), (4096, 768, 300, 16, False)]
LORA = [(4096, 768, 2048), (4096, 2048, 768), (4096, 768, 768), (8, 768, 768), (8, 2048, 768),
        (8, 768, 2048), (8, 768, 256), (8, 18432, 4608), (8, 22528, 8192), (2, 14336, 3584),
        (2, 3584, 14336)]  # M, K, N at rank 16
# M, K, N, r above rank 64: fedsllm-100m's four shapes at rank 128, prefill
# and decode; then rank 256 and mistral-7b's w_gate (K=4096, N=14336)
HIGH = [(M, K, N, 128) for M in (4096, 8)
        for K, N in ((768, 2048), (2048, 768), (768, 768), (768, 256))]
HIGH += [(4096, 768, 2048, 256), (8, 768, 768, 256), (4096, 4096, 14336, 128),
         (8, 4096, 14336, 128)]
# bf16 ranks that are not multiples of 8, and above 256 (once on generic)
HIGH += [(M, K, N, r) for r in (4, 100, 512) for M, K, N in ((4096, 768, 2048), (8, 768, 768))]
# fp32 (M, K, N, r): fedsllm-100m's four shapes at prefill and decode, ranks
# 80 and 128, gemma2-9b's w_gate/w_up and w_down at its decode batch (M=2)
FP32 = [(M, K, N, 16) for M in (4096, 8)
        for K, N in ((768, 2048), (2048, 768), (768, 768), (768, 256))]
FP32 += [(M, K, N, r) for r in (80, 128) for M, K, N in ((4096, 768, 2048), (8, 768, 768))]
FP32 += [(2, 3584, 14336, 16), (2, 14336, 3584, 16)]
# (K, N) of the fp32 smoke serves' LoRA products at rank 16 (fedsllm-100m's
# and mamba2-130m's smoke configs), with their launches in one serve of
# each: 2 layers, a prefill at M = 4·32 and 15 decode steps at M = 4
SMOKE = {(64, 64): 4, (64, 32): 4, (64, 128): 4, (128, 64): 4, (64, 296): 2}
SMOKE_CALLS = {128: 1, 4: 15}
FP32 += [(M, K, N, 16) for M in SMOKE_CALLS for K, N in SMOKE]
HOST = [(8, 768, 768), (8, 2048, 768), (8, 768, 2048)]
# bf16 flash (B, S, H, Kv, d, q one element off 16 bytes) and the SSD scan
# (B, S, H, P, N, fp32) of the first port's last two variants' designs
NEXT_FLASH = [(8, 512, 12, 4, 16, False), (8, 512, 12, 4, 32, False), (8, 512, 12, 4, 64, True),
              (8, 512, 24, 8, 128, True), (2, 2048, 16, 8, 256, True)]
NEXT_SSD = [(8, 512, 24, 64, 128, True), (4, 32, 8, 16, 16, True), (8, 512, 24, 64, 128, False)]
# the kernels' last inputs (bf16): flash at head dims between the compiled
# widths, the SSD scan above N=256 (the first port's ``fma`` took N=320)
LAST_FLASH = [(8, 512, 12, 4, 48, False), (8, 512, 12, 4, 96, False)]
LAST_SSD = [(2, 512, 4, 64, 320, False), (2, 512, 4, 64, 1024, False)]


def graph_ms(torch, fn, sets, iters=50):
    """Mean device time a call: `iters` calls cycling through `sets`,
    captured into one CUDA graph and replayed between two events."""
    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, sets, iters=2000):
    """Host time a call, with no synchronisation in the loop."""
    for args in sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    t = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return t


def event_ms(torch, fn, sets, iters=200):
    """Time a call of back-to-back calls between two events: the larger of
    the host's and the card's time where the calls are launch-bound."""
    for args in sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def lora_sets(torch, randn, M, K, N, r, dtype):
    esize = 4 if dtype == torch.float32 else 2
    n = max(2, -(-120_000_000 // (esize * K * N)))  # > 120 MB of W: a cold L2 every call
    return [(randn(M, K, dtype=dtype), randn(K, N, scale=0.05, dtype=dtype),
             randn(K, r, scale=0.05, dtype=dtype), randn(r, N, scale=0.05, dtype=dtype))
            for _ in range(n)]


def shift(torch, t):
    """t's values in a view one element off its buffer's 16-byte aligned
    start: no tensor map reads it."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view_as(t).copy_(t)


def measure(root: Path) -> dict:
    """One side: every metric of the module docstring, with `root`'s kernels."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels.attn_ops import flash_attention
    from repro_torch.kernels.lora_ops import lora_matmul

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    out = {}
    flash = [(*f, torch.bfloat16) for f in FLASH] + [(*f, torch.float32) for f in FLASH_FP32]
    for B, S, H, Kv, d, window, cap, dtype in flash:
        sets = [(randn(B, S, H, d, dtype=dtype).transpose(1, 2),
                 randn(B, S, Kv, d, dtype=dtype).transpose(1, 2),
                 randn(B, S, Kv, d, dtype=dtype).transpose(1, 2)) for _ in range(2 if S > 512 else 8)]
        fn = lambda q, k, v: flash_attention(q, k, v, causal=True, window=window,  # noqa: E731
                                             softcap=cap)
        name = "flash" + (" fp32" if dtype == torch.float32 else "")
        out[f"{name} d={d} B={B} S={S} H={H}/{Kv} window={window} softcap={cap:g}"] = graph_ms(
            torch, fn, sets, 4 if S > 512 else 50)
        del sets
    for M, K, N, r, shifted in COPIED:
        sets = [(shift(torch, x) if shifted else x, w, a, b)
                for x, w, a, b in lora_sets(torch, randn, M, K, N, r, torch.bfloat16)]
        fn = lambda x, w, a, b: lora_matmul(x, w, a, b, scale=2.0)  # noqa: E731
        out[f"lora copied {M}x{K}x{N}" + (" x+1" if shifted else "")] = graph_ms(torch, fn, sets)
        del sets
    rows = [(*s, 16, torch.bfloat16) for s in LORA] + [(*s, torch.bfloat16) for s in HIGH]
    for M, K, N, r, dtype in rows + [(*s, torch.float32) for s in FP32]:
        sets = lora_sets(torch, randn, M, K, N, r, dtype)
        fn = lambda x, w, a, b: lora_matmul(x, w, a, b, scale=2.0)  # noqa: E731
        name = ("lora fp32 " if dtype == torch.float32 else "lora ") + f"{M}x{K}x{N}" + \
            (f" r={r}" if r != 16 else "")
        out[name] = graph_ms(torch, fn, sets, 10 if M * K * N * r > 1e12 else 50)
        if (M, K, N) in HOST and r == 16 and dtype == torch.bfloat16:
            out[f"host {M}x{K}x{N}"] = host_ms(torch, fn, sets)
        if (K, N) in SMOKE and M in SMOKE_CALLS and dtype == torch.float32:
            out[f"host fp32 {M}x{K}x{N}"] = host_ms(torch, fn, sets)
            out[f"event fp32 {M}x{K}x{N}"] = event_ms(torch, fn, sets)
        del sets
    for metric, key in (("device", "lora fp32"), ("host", "host fp32"), ("event", "event fp32")):
        out[f"smoke serves fp32 {metric} ms, 288 launches"] = sum(
            out[f"{key} {M}x{K}x{N}"] * n * calls
            for M, calls in SMOKE_CALLS.items() for (K, N), n in SMOKE.items())
    out.update(measure_next(torch, randn))
    return out


def measure_next(torch, randn) -> dict:
    """The ``NEXT`` rows (module docstring) on one side."""
    from repro_torch.kernels.attn_ops import flash_attention
    from repro_torch.kernels.ssd_ops import ssd_scan

    out = {}

    def taken(name, fn, sets, iters=50):
        """The row's graph ms, or nothing where this side's wrapper raises."""
        try:
            out[name] = graph_ms(torch, fn, sets, iters)
        except ValueError as e:
            print(f"{name}: not taken ({e})", file=sys.stderr)

    for B, S, H, Kv, d, misaligned in NEXT_FLASH + LAST_FLASH:
        sets = [((shift(torch, q) if misaligned else q).transpose(1, 2),
                 randn(B, S, Kv, d).transpose(1, 2), randn(B, S, Kv, d).transpose(1, 2))
                for q in (randn(B, S, H, d) for _ in range(4))]
        name = f"next flash d={d} B={B} S={S} H={H}/{Kv}" + (" q+1" if misaligned else "")
        taken(name, lambda q, k, v: flash_attention(q, k, v, causal=True), sets)
        del sets
    for B, S, H, P, N, fp32 in NEXT_SSD + LAST_SSD:
        dtype = torch.float32 if fp32 else torch.bfloat16
        sets = [(randn(B, S, H, P, dtype=dtype),
                 torch.nn.functional.softplus(randn(B, S, H, dtype=torch.float32)),
                 -torch.exp(randn(H, scale=0.3, dtype=torch.float32)),
                 randn(B, S, N, scale=0.5, dtype=dtype), randn(B, S, N, scale=0.5, dtype=dtype),
                 randn(B, H, P, N, dtype=torch.float32)) for _ in range(4)]
        name = f"next ssd {'fp32' if fp32 else 'bf16'} B={B} S={S} H={H} P={P} N={N}"
        taken(name, lambda x, dt, A, Bm, Cm, h: ssd_scan(x, dt, A, Bm, Cm, initial_state=h),
              sets, 20)
        del sets
    return out


def sweep() -> None:
    """The alternatives to this checkout's LoRA rule (module docstring): a
    JSON line for each shape, its graph and event ms under each choice."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    from repro_torch.kernels import lora_matmul as binding

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def row(what, M, K, N, r, dtype, choices):
        sets = lora_sets(torch, randn, M, K, N, r, dtype)
        res = dict(sweep=what, M=M, K=K, N=N, r=r, MKN=M * K * N, rule=binding.plan(
            M, K, N, r, True, dtype == torch.float32)[1])
        for label, (kind, extra) in choices.items():
            fn = lambda x, w, a, b: binding.lora_matmul_cuda(  # noqa: E731
                x, w, a, b, 2.0, kind, extra)
            res[f"{label} graph"] = graph_ms(torch, fn, sets)
            res[f"{label} event"] = event_ms(torch, fn, sets)
        print(json.dumps(res), flush=True)
        del sets

    f32 = torch.float32
    # fp32 prefill at rank 16: one launch (the SIMT tile with u fused) or two
    # (u, then the product in 3xTF32), at the smoke serves' prefill shapes
    # and up a ladder of M·K·N across FP32_TWO_LAUNCH_WORK
    ladder = [(128, K, N) for K, N in SMOKE] + [
        (128, 128, 128), (128, 256, 256), (32, 768, 768), (128, 768, 256), (128, 384, 384),
        (512, 256, 256), (128, 512, 512), (256, 512, 512),
        (128, 768, 768), (256, 768, 768), (512, 768, 768), (1024, 768, 256), (1024, 768, 768),
        (2048, 768, 768), (1024, 768, 2048), (4096, 768, 256), (4096, 768, 768)]
    for M, K, N in ladder:
        row("fp32 prefill launches", M, K, N, 16, f32, {
            "one": ("fp32", (0, 0, 0, 0, 0)),
            "two": ("fp32", (0, 0, binding.fp32_tile_n(M, N), 0, 1))})
    # fp32 decode: W by cp.async or by TMA, up a ladder of W's bytes across
    # FP32_TMA_W_BYTES (4 MB), from the smoke decode to gemma2-9b's MLP
    for M, K, N in [(4, 64, 64), (4, 64, 296), (8, 256, 256), (8, 512, 512), (8, 768, 768),
                    (8, 1024, 1024), (8, 768, 2048), (8, 2048, 768), (8, 2048, 2048),
                    (8, 4096, 4096), (2, 3584, 14336), (2, 14336, 3584)]:
        split, usplit, _, _, two = binding.plan(M, K, N, 16, True, True)[1]
        row("fp32 decode W", M, K, N, 16, f32, {
            f"tma={t}": ("fp32", (split, usplit, 0, t, two)) for t in (0, 1)})
    # bf16 prefill with A copied (r % 8 != 0, 16 < r <= 64): tiles 128 or
    # 192 wide where the rule picks 192 (fedsllm-100m's wq, wo at N = 768)
    for r in (17, 33, 63):
        for M, K, N in [(4096, 768, 768), (4096, 2048, 768)]:
            row("bf16 prefill copied-A tile", M, K, N, r, torch.bfloat16, {
                f"bn={bn}": ("prefill", (bn, 1)) for bn in (128, 192)})
    # bf16 prefill and decode: x's or W's tiles copied by the producers (the
    # same values one element off 16 bytes) or read by TMA, at fedsllm-100m's
    # and gemma2-9b's shapes; the copied launch's tile as the rule picks it
    for M, K, N in [(4096, 768, 2048), (4096, 2048, 768), (8, 768, 768), (8, 768, 2048),
                    (8, 3584, 14336), (8, 14336, 3584)]:
        for operand in ("x", "w"):
            sets = lora_sets(torch, randn, M, K, N, 16, torch.bfloat16)
            res = dict(sweep=f"bf16 copied {operand} against TMA", M=M, K=K, N=N, r=16,
                       MKN=M * K * N)
            for label, aligned in (("tma", True), ("copied", False)):
                kind, extra = binding.plan(M, K, N, 16, aligned)
                use = sets if aligned else [
                    (shift(torch, x), w, a, b) if operand == "x" else (x, shift(torch, w), a, b)
                    for x, w, a, b in sets]
                fn = lambda x, w, a, b: binding.lora_matmul_cuda(  # noqa: E731
                    x, w, a, b, 2.0, kind, extra)
                res[f"{label} graph"] = graph_ms(torch, fn, use)
                res[f"{label} event"] = event_ms(torch, fn, use)
                res[f"{label} extra"] = list(extra)
            print(json.dumps(res), flush=True)
            del sets


def host_ab(other: Path, rounds: int = 15, calls: int = 200) -> None:
    """Both sides' ``lora_matmul`` in one process (module docstring): a JSON
    line for each fp32 smoke shape, then the sums over the 288 launches."""
    import statistics

    import torch

    fns, flash = {}, {}
    for side, root in (("other", other), ("this", Path(__file__).resolve().parent)):
        for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
            del sys.modules[name]
        sys.path.insert(0, str(root / "src"))
        from repro_torch.kernels.attn_ops import flash_attention
        from repro_torch.kernels.lora_ops import lora_matmul
        fns[side], flash[side] = lora_matmul, flash_attention
        sys.path.pop(0)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    med = {}
    for M, calls_per_serve in SMOKE_CALLS.items():
        for (K, N), n in SMOKE.items():
            sets = lora_sets(torch, randn, M, K, N, 16, torch.float32)
            times = {side: {"host": [], "event": []} for side in fns}
            for side, fn in fns.items():
                for x, w, a, b in sets[:3]:
                    fn(x, w, a, b, scale=2.0)
            torch.cuda.synchronize()
            for i in range(rounds):
                for side in (("other", "this") if i % 2 == 0 else ("this", "other")):
                    fn = fns[side]
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    t0 = time.perf_counter()
                    for j in range(calls):
                        x, w, a, b = sets[j % len(sets)]
                        fn(x, w, a, b, scale=2.0)
                    t = time.perf_counter() - t0
                    end.record()
                    end.synchronize()
                    times[side]["host"].append(t / calls * 1e3)
                    times[side]["event"].append(start.elapsed_time(end) / calls)
            row = {f"{side} {k}": statistics.median(v)
                   for side, d in times.items() for k, v in d.items()}
            med[(M, K, N)] = (row, n * calls_per_serve)
            print(json.dumps({"shape": f"fp32 {M}x{K}x{N}", **row}), flush=True)
            del sets
    total = {k: sum(row[k] * launches for row, launches in med.values())
             for k in next(iter(med.values()))[0]}
    print(json.dumps({"smoke serves fp32, 288 launches (ms)": total,
                      "ratio host": total["this host"] / total["other host"],
                      "ratio event": total["this event"] / total["other event"]}), flush=True)
    sets = [tuple(randn(4, 32, n, 16).transpose(1, 2) for n in (4, 2, 2)) for _ in range(4)]
    times = {side: {"host": [], "event": []} for side in flash}
    for side, fn in flash.items():
        for q, k, v in sets:
            fn(q, k, v, causal=True)
    torch.cuda.synchronize()
    for i in range(rounds):
        for side in (("other", "this") if i % 2 == 0 else ("this", "other")):
            fn = flash[side]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for j in range(calls):
                q, k, v = sets[j % len(sets)]
                fn(q, k, v, causal=True)
            t = time.perf_counter() - t0
            end.record()
            end.synchronize()
            times[side]["host"].append(t / calls * 1e3)
            times[side]["event"].append(start.elapsed_time(end) / calls)
    row = {f"{side} {k}": statistics.median(v) for side, d in times.items() for k, v in d.items()}
    print(json.dumps({"shape": "flash fp32 B=4 S=32 4/2 d=16, the smoke serve's", **row,
                      "ratio host": row["this host"] / row["other host"],
                      "ratio event": row["this event"] / row["other event"]}))


def ptxas() -> None:
    import tempfile

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from chip_smoke import ptxas_summary
    from repro_torch.kernels import _build

    src = _build.CSRC / "flash_attention.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        procs = {build: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", f"{tmp}/{build}.so", str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for build, flags in (("served", ()), ("full_only", ("-DREPRO_FLASH_FULL_ONLY",)))}
        for build, proc in procs.items():
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed ({build}):\n{out}")
            for row in ptxas_summary(out):
                print(json.dumps({"build": build, **row}))


def main() -> int:
    if sys.argv[1:] == ["--ptxas"]:
        ptxas()
        return 0
    if sys.argv[2:] == ["--host"]:
        host_ab(Path(sys.argv[1]).resolve())
        return 0
    if sys.argv[1:] == ["--sweep"]:
        sweep()
        return 0
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sides = {"other": Path(sys.argv[1]).resolve(), "this": Path(__file__).resolve().parent}
    runs = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        res = subprocess.run([sys.executable, __file__, "--measure", str(sides[side])],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        runs[side].append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps({"side": side, "root": str(sides[side]), **runs[side][-1]}), flush=True)
    best = {side: {k: min(r[k] for r in rs) for k in rs[0]} for side, rs in runs.items()}
    print(json.dumps({k: {"other": best["other"].get(k), "this": best["this"][k],
                          "ratio": best["this"][k] / best["other"][k]
                          if k in best["other"] else None} for k in best["this"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
