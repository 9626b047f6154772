"""Serving entry point: batched prefill + greedy decode of a LoRA-adapted model.

Usage (on the GPU; ``--device cpu`` runs the plain versions on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch fedsllm-100m \
      --batch 8 --prompt-len 512 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --batch 8 --prompt-len 512 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
      --batch 2 --prompt-len 8192 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --batch 8 --prompt-len 512 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
      --batch 2 --prompt-len 4096 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke   # fp32, on the card

``--arch`` takes every config the port runs: fedsllm-100m, mamba2-130m, the
dense family (phi4-mini-3.8b, starcoder2-7b, command-r-35b, gemma2-9b, whose
sliding-window layers keep a ring-buffer cache of 4096 slots), the MoE
family (olmoe-1b-7b, qwen3-moe-235b-a22b: 235 B parameters, which one card
does not hold at full depth) and the hybrid recurrentgemma-9b (RG-LRU
blocks and windowed attention, its ring of 2048 slots).

The adapters are freshly initialised (A ~ N(0,1)/r, B = 0, as a FedsLLM run
starts), so the output equals the base model's; every adapted projection
still runs the fused LoRA kernel (``--lora-rank`` sets their rank, the
config's by default). ``--smoke`` serves the reduced fp32 config, through
the kernels' fp32 variants on the card. Prints tokens/s and every kernel's
launch count, by variant.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.config import LoRAConfig, get_arch, smoke_variant
from repro_torch.core.lora import init_lora
from repro_torch.device import resolve_device
from repro_torch.kernels.attn_ops import flash_attention
from repro_torch.kernels.lora_ops import lora_matmul
from repro_torch.kernels.ssd_ops import ssd_scan
from repro_torch.models import transformer as T
from repro_torch.serving.decode import decode_tokens


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fedsllm-100m",
                    help="a registered config: fedsllm-100m, mamba2-130m, phi4-mini-3.8b, "
                         "starcoder2-7b, command-r-35b, gemma2-9b, olmoe-1b-7b, "
                         "qwen3-moe-235b-a22b, recurrentgemma-9b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--lora-rank", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.lora_rank is not None:
        cfg = cfg.replace(lora=dataclasses.replace(cfg.lora or LoRAConfig(), rank=args.lora_rank))
    params = T.init_params(cfg, seed=0, device=dev)
    lora = init_lora(params, cfg, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                           device=dev)
    kernels = {"lora_matmul": lora_matmul, "flash_attention": flash_attention,
               "ssd_scan": ssd_scan}
    for fn in kernels.values():
        fn.launches = 0
        fn.variant_launches.update(dict.fromkeys(fn.variant_launches, 0))
    t0 = time.perf_counter()
    out = decode_tokens(params, cfg, prompt, args.max_new, lora=lora, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={dev.type} generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s)")
    print("kernel launches: " + " ".join(f"{n}={fn.launches}" for n, fn in kernels.items()))
    print("by variant: " + " ".join(f"{n}={fn.variant_launches}" for n, fn in kernels.items()))
    print("sample tokens:", out[0, :12].tolist())
    return out


if __name__ == "__main__":
    main()
