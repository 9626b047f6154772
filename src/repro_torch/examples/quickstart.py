"""Quickstart: train a small decoder LM for a few steps and generate, then
run the same model through the unified FedsLLM ``Experiment`` API (split +
federated + simulated wireless) in five lines (port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import torch

from repro_torch.api import Experiment
from repro_torch.config import (FedsLLMConfig, RunConfig, SHAPES, TrainConfig,
                                get_arch, smoke_variant)
from repro_torch.data.tokens import TokenStream, client_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.serving.decode import decode_tokens


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = smoke_variant(get_arch("fedsllm-100m")).replace(vocab_size=512)
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=60, warmup_steps=10,
                       remat="none")
    params = T.init_params(cfg, seed=0, device=dev)
    step_fn, opt = make_train_step(cfg, tcfg)
    opt_state = opt.init(params)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    stream = TokenStream(batch=8, seq=64, vocab=cfg.vocab_size, seed=0, device=dev)

    first = last = None
    for i in range(tcfg.total_steps):
        params, opt_state, step, metrics = step_fn(params, opt_state, step,
                                                   stream.batch_at(i))
        loss = float(metrics["loss"])
        first = first if first is not None else loss
        last = loss
        if i % 10 == 0:
            print(f"step {i:3d}  loss {loss:.4f}")
    print(f"\nloss {first:.3f} -> {last:.3f} (structured synthetic stream)")

    prompt = stream.batch_at(999)["tokens"][:2, :8]
    out = decode_tokens(params, cfg, prompt, max_new=8, device=dev)
    print("generated:", out[0].tolist())

    # --- the same model, federated + split, via the unified API ------------
    run_cfg = RunConfig(model=cfg, shape=SHAPES["train_4k"],
                        fedsllm=FedsLLMConfig(num_clients=4))
    exp = Experiment.from_config(run_cfg, allocator="EB", device=dev)
    res = exp.run_round(client_batches(stream, 0, exp.cohort))
    print(f"\nfederated round via Experiment: loss "
          f"{float(res.metrics['loss_round_start']):.3f} -> "
          f"{float(res.metrics['loss_local_final']):.3f}, "
          f"simulated round wall-clock {res.wall_clock:.2f}s")
    return {"first_loss": first, "last_loss": last, "generated": out, "round": res}


if __name__ == "__main__":
    main()
