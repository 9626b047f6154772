"""Batched serving demo: prefill + decode with KV- and state-caches, for the
families the port runs (dense ``fedsllm-100m``, SSM ``mamba2-130m``; port
of ``examples/serve_demo.py``). The reference's third family, the hybrid
``recurrentgemma-9b``, waits for the port of its layers.

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.config import get_arch, smoke_variant
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.decode import decode_tokens

ARCHS = ("fedsllm-100m", "mamba2-130m")
WAITING = ("recurrentgemma-9b",)  # the hybrid family (RG-LRU + banded attention)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    out = {}
    for arch in ARCHS:
        cfg = smoke_variant(get_arch(arch))
        params = T.init_params(cfg, seed=0, device=dev)
        B, Sp, new = 4, 16, 12
        gen = torch.Generator(device=dev).manual_seed(1)
        prompt = torch.randint(0, cfg.vocab_size, (B, Sp), generator=gen, device=dev)
        t0 = time.time()
        out[arch] = decode_tokens(params, cfg, prompt, max_new=new, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        print(f"{arch:22s} family={cfg.family:7s} batch={B} "
              f"generated {out[arch].shape[1]} tokens/row in {dt:5.2f}s "
              f"({B*new/dt:6.1f} tok/s, first call)")
    for arch in WAITING:
        print(f"{arch:22s} family=hybrid  not ported yet: waits for the hybrid family's "
              "layers (ROADMAP.md, other architectures)")
    return out


if __name__ == "__main__":
    main()
