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
and at a few shapes at ranks 128 and 256 up to mistral-7b's w_gate (K=4096,
N=14336), and the host's time a call at fedsllm-100m's decode shapes; the
last line holds each metric's least time on each side and their ratio
(this / other).
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
LORA = [(4096, 768, 2048), (4096, 2048, 768), (4096, 768, 768), (8, 768, 768), (8, 2048, 768),
        (8, 768, 2048), (8, 768, 256), (8, 18432, 4608), (8, 22528, 8192), (2, 14336, 3584),
        (2, 3584, 14336)]  # M, K, N at rank 16
# M, K, N, r above rank 64: fedsllm-100m's four shapes at rank 128, prefill
# and decode; then rank 256 and mistral-7b's w_gate (K=4096, N=14336)
HIGH = [(M, K, N, 128) for M in (4096, 8)
        for K, N in ((768, 2048), (2048, 768), (768, 768), (768, 256))]
HIGH += [(4096, 768, 2048, 256), (8, 768, 768, 256), (4096, 4096, 14336, 128),
         (8, 4096, 14336, 128)]
HOST = [(8, 768, 768), (8, 2048, 768), (8, 768, 2048)]


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


def measure(root: Path) -> dict:
    """One side: every metric of the module docstring, with `root`'s kernels."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels.attn_ops import flash_attention
    from repro_torch.kernels.lora_ops import lora_matmul

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).bfloat16()

    out = {}
    for B, S, H, Kv, d, window, cap in FLASH:
        sets = [(randn(B, S, H, d).transpose(1, 2), randn(B, S, Kv, d).transpose(1, 2),
                 randn(B, S, Kv, d).transpose(1, 2)) for _ in range(2 if S > 512 else 8)]
        fn = lambda q, k, v: flash_attention(q, k, v, causal=True, window=window,  # noqa: E731
                                             softcap=cap)
        out[f"flash d={d} S={S} window={window} softcap={cap:g}"] = graph_ms(
            torch, fn, sets, 4 if S > 512 else 50)
        del sets
    for M, K, N, r in [(*s, 16) for s in LORA] + HIGH:
        n = max(2, -(-120_000_000 // (2 * K * N)))  # > 120 MB of W: a cold L2 every call
        sets = [(randn(M, K), randn(K, N, scale=0.05), randn(K, r, scale=0.05),
                 randn(r, N, scale=0.05)) for _ in range(n)]
        fn = lambda x, w, a, b: lora_matmul(x, w, a, b, scale=2.0)  # noqa: E731
        name = f"lora {M}x{K}x{N}" + (f" r={r}" if r != 16 else "")
        out[name] = graph_ms(torch, fn, sets, 10 if M * K * N * r > 1e12 else 50)
        if (M, K, N) in HOST and r == 16:
            out[f"host {M}x{K}x{N}"] = host_ms(torch, fn, sets)
        del sets
    return out


def main() -> int:
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
    print(json.dumps({k: {"other": best["other"][k], "this": best["this"][k],
                          "ratio": best["this"][k] / best["other"][k]} for k in best["this"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
