"""Training entry point (port of ``repro/launch/train.py``).

Runs a real training loop on the card, or on the CPU with ``--device cpu``.
Features: checkpoint/auto-resume (atomic, through ``checkpoint.Checkpointer``;
the resumed run ends on the uninterrupted run's bits), deterministic
index-based data, cosine schedule, grad clipping, and the FedsLLM campaign
mode (``--fedsllm``) with every strategy axis of ``api.Experiment``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch fedsllm-100m \\
      --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch fedsllm-100m --fedsllm \\
      --clients 8 --rounds 5 --eta 0.5 --cohort 4 --deadline 120
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 20
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.config import FedsLLMConfig, TrainConfig, get_arch, smoke_variant
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T


def train_standard(args):
    """Train every parameter of the model (no adapters) for ``--steps``
    steps; returns the params."""
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(10, args.steps // 20),
                       remat="full" if args.remat else "none")
    params = T.init_params(cfg, seed=tcfg.seed, device=dev)
    step_fn, opt = make_train_step(cfg, tcfg)
    opt_state = opt.init(params)
    step = torch.zeros((), dtype=torch.int32, device=dev)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt is not None:
        got = ckpt.restore_or_none(device=dev)
        if got is not None:
            (params, opt_state, step), meta = got
            start = int(meta["step"])
            print(f"resumed from step {start}")

    stream = TokenStream(args.batch, args.seq, cfg.vocab_size, seed=tcfg.seed, device=dev)
    t0 = time.time()
    for i in range(start, args.steps):
        batch = stream.batch_at(i)
        params, opt_state, step, metrics = step_fn(params, opt_state, step, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            print(f"step {i:5d}  loss {loss:.4f}  gnorm {float(metrics['grad_norm']):.3f}"
                  f"  ({time.time()-t0:.1f}s)", flush=True)
        if ckpt is not None and (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, (params, opt_state, step))
    if ckpt is not None:
        ckpt.save(args.steps, (params, opt_state, step))
    return params


def train_fedsllm(args):
    """Paper mode: a multi-round FedsLLM campaign with simulated wireless.

    One ``Experiment`` wires model init, the split cut, the round function,
    the §IV channel model and the delay-minimisation allocator; the strategy
    axes are selected by name (--aggregator/--allocator/--codec/...).
    ``Experiment.run`` (the ``repro_torch.sim`` campaign engine) then drives
    the rounds: per-round channel evolution under the named --scenario
    (disable with --freeze-channel; re-solve the allocator jointly per round,
    η included, with --reallocate), elastic cohorts (--cohort < --clients),
    deadline stragglers (--deadline) and periodic checkpointing with
    auto-resume (--ckpt-dir/--ckpt-every). The simulated times are the host's
    numpy and do not depend on the model or the device.
    """
    from repro_torch.api import Experiment
    from repro_torch.config import RunConfig, ShapeConfig

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    run_cfg = RunConfig(
        model=cfg,
        shape=ShapeConfig("cli", "train", args.seq, args.batch),
        fedsllm=FedsLLMConfig(num_clients=args.clients),
    )
    exp = Experiment.from_config(run_cfg, eta=args.eta, lora_rank=args.lora_rank,
                                 aggregator=args.aggregator,
                                 allocator=args.allocator, compressor=args.codec,
                                 scenario=args.scenario,
                                 topology=args.topology,
                                 schedule=args.schedule,
                                 local_algo=args.local_algo,
                                 workload=args.workload, device=dev)
    print(exp.describe())

    stream = TokenStream(args.batch, args.seq, cfg.vocab_size, seed=0, device=dev)
    t0 = time.time()

    def log(rec):
        print(f"round {rec.round:3d}  "
              f"survivors {rec.survivors}/{rec.cohort_size}  "
              f"loss_start {rec.metrics['loss_round_start']:.4f}  "
              f"loss_local_end {rec.metrics['loss_local_final']:.4f}  "
              f"simulated {rec.cumulative_time:9.1f}s  "
              f"({time.time()-t0:.1f}s)", flush=True)

    res = exp.run(num_rounds=args.rounds, stream=stream,
                  cohort=args.cohort or None,
                  resample_channel=not args.freeze_channel,
                  reallocate=args.reallocate, deadline=args.deadline,
                  stop_at_lemma1=args.stop_lemma1,
                  checkpoint_dir=args.ckpt_dir,
                  checkpoint_every=args.ckpt_every if args.ckpt_dir else 0,
                  resume=bool(args.ckpt_dir), on_round=log)
    print(f"{res.num_rounds} rounds ({res.stopped_by}; Lemma-1 budget "
          f"{res.rounds_lemma1}), {res.total_time:.1f}s simulated, "
          f"straggler rate {res.straggler_rate:.1%}, round functions built {exp.trace_count}")
    return res.state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fedsllm-100m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    # fedsllm mode
    ap.add_argument("--fedsllm", action="store_true")
    ap.add_argument("--clients", type=int, default=8,
                    help="simulated radio population K")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--cohort", type=int, default=0,
                    help="clients trained per round (< clients = elastic "
                         "subsampling; 0 = all)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-round straggler deadline, simulated seconds")
    ap.add_argument("--freeze-channel", action="store_true",
                    help="keep round 0's channel draw for every round")
    ap.add_argument("--reallocate", action="store_true",
                    help="re-solve the allocator on every round's channel draw")
    ap.add_argument("--stop-lemma1", action="store_true",
                    help="cap rounds at Lemma 1's a/(1-eta) budget")
    ap.add_argument("--eta", type=float, default=0.5)
    ap.add_argument("--lora-rank", type=int, default=8)
    ap.add_argument("--aggregator", default="weighted",
                    help="fed-server reduction (repro_torch.api.aggregators)")
    ap.add_argument("--allocator", default="proposed",
                    help="resource-allocation strategy (repro_torch.api.allocators)")
    ap.add_argument("--codec", default="none",
                    help="smashed-activation uplink codec (repro_torch.api.compressors)")
    ap.add_argument("--scenario", default="blockfade",
                    help="channel-dynamics scenario (repro_torch.sim.scenario): "
                         "frozen | blockfade | geo-blockfade | drift | "
                         "hetero | outage | shadowing")
    ap.add_argument("--topology", default="star",
                    help="network graph (repro_torch.net.topology): star | "
                         "edge-cloud | edge-agg | relay; non-star needs a "
                         "geometry scenario, e.g. --scenario geo-blockfade")
    ap.add_argument("--schedule", default="sync",
                    help="execution discipline (repro_torch.des.schedules): sync "
                         "| pipelined | async | semi-async; async runs the "
                         "full population and aggregates arrivals "
                         "staleness-weighted")
    ap.add_argument("--local-algo", default="gd",
                    help="client local-update rule (repro_torch.fl.local_algos): "
                         "gd | fedprox | scaffold")
    ap.add_argument("--workload", default="iid",
                    help="per-client data distribution (repro_torch.fl.workloads): "
                         "iid | quantity-skew | length-skew | dirichlet")
    args = ap.parse_args(argv)
    if args.fedsllm:
        return train_fedsllm(args)
    return train_standard(args)


if __name__ == "__main__":
    main()
