"""Readings behind the limits of ``correct``, on the card, many seeds in one
process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 ... [--mode M] [--seconds S]

``--mode``: ``program`` (sound runs: the lower readings), ``control`` (the
reference one precision step down in the program's place: float8 e4m3 for
bfloat16), or a fault planted in the timed path: ``unchanged`` (a round that
returns its state unchanged), ``half_batch`` (half of each client's rows,
the mean over the rest), ``token_altered`` (a served token altered where it
is produced). One JSON line per seed on standard output. The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def session(cell, seed, seconds, mode, device="cuda"):
    import torch

    from portbench.harness import kinds
    from portbench.harness.runner import Run
    from portbench.reference.lowp import QUANT

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    run = Run(cell, seed, seconds, torch.device(device), sync=sync,
              fault=None if mode in ("program", "control") else mode,
              control=QUANT["fp8"] if mode == "control" else None)
    return kinds.get(cell.traffic["kind"]).Session(run)


def readings(cell, seed, seconds, mode, device="cuda") -> dict:
    import torch

    cuda = device == "cuda"
    t = time.perf_counter()
    s = session(cell, seed, seconds, mode, device=device)
    window = s.window(seconds)
    if cuda:
        torch.cuda.synchronize()
    out = {"seed": seed, "mode": mode, "steps": len(window["steps"]),
           "setup_and_window_s": time.perf_counter() - t}
    if hasattr(s, "served"):  # a served token equal to its prompt's last token
        out["echo_share"] = sum(tok == int(s.prompts(i)[0, -1]) for i, tok in s.served.items()) \
            / max(1, len(s.served))
    s.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out.update(s.check())
    out["check_s"] = time.perf_counter() - t
    if getattr(s, "left_out", None):
        out["left_out"] = [list(k) for k in s.left_out]
    out.update(getattr(s, "diag", {}))
    del s
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", default="program",
                   choices=("program", "control", "unchanged", "half_batch", "token_altered"))
    p.add_argument("--seconds", type=float, default=0.01)
    p.add_argument("--adapter-dtype", choices=("bfloat16", "float32"),
                   help="hold the adapters in this type instead of the configuration's (a witness)")
    args = p.parse_args(argv)
    import torch

    from portbench.harness import spec

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    if args.adapter_dtype:
        lora = dict(cell.config["lora"], dtype=args.adapter_dtype)
        cell = dataclasses.replace(cell, config=dict(cell.config, lora=lora))
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, args.mode)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
