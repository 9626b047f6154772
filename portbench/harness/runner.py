"""One run of one cell: set-up, the measured window, the traced part
(``--trace 1``), the check against the plain reference, and the result line.

``run_cell`` takes the device to run on, so that the tests can drive a whole
run on the CPU; ``run.py`` insists on the card.
"""

from __future__ import annotations

import gc
import math
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from portbench import libraries
from portbench.harness import kinds, spec
from portbench.harness import trace as tracing


@dataclass
class Run:
    cell: spec.Cell
    seed: int
    seconds: float
    device: torch.device
    fault: Optional[str] = None  # a fault planted in the timed path (tests, calibration)
    control: Optional[Callable] = None  # the precision control in the program's place
    sync: Callable = field(default=lambda: None)


@dataclass
class Context:
    """What a metric's reader reads (``metrics/<name>.py``: ``read(ctx)``)."""

    cell: spec.Cell
    setup_s: float
    window: dict
    window_peak_bytes: Optional[int]
    timeline: Optional[tracing.Timeline]
    power_limit_w: Optional[float]


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def limits(cell: spec.Cell) -> dict:
    return spec.load_json(cell.root / "portbench" / "limits" / f"{cell.name}.json")["limits"]


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t0: Optional[float] = None, **kw) -> tuple[dict, list[str]]:
    """Returns (the result object, the check lines for standard error)."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    run = Run(cell, seed, seconds, device, sync=sync, **kw)
    parts = {"imports": time.perf_counter() - t0}
    if cuda:
        torch.empty(1, device=device)
        sync()
        parts["cuda_start"] = time.perf_counter() - t0
    session = kinds.get(cell.traffic["kind"]).Session(run)
    sync()
    parts["session"] = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    window = session.window(seconds)
    sync()
    window_peak = torch.cuda.max_memory_allocated() if cuda else None
    power = power_limit_w() if cuda else None
    timeline = (tracing.trace_part(session.traced_part, libraries.load(), sync, cuda) if trace
                else None)
    session.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = session.check()
    bounds = limits(cell)
    correct = set(numbers) <= set(bounds) and all(
        math.isfinite(v) and v <= bounds[k] for k, v in numbers.items())
    ctx = Context(cell, setup_s, window, window_peak, timeline, power)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], cell.root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 1,
           "memory_peak_bytes": max(setup_peak, window_peak) if cuda else None,
           "power_limit_w": power}
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if timeline is not None:
        dev.update(busy_s=timeline.busy_s, window_s=timeline.window_s)
        result["breakdown"] = tracing.breakdown(timeline)
        result["trace"] = {"whole": timeline.whole, "recorded": timeline.recorded,
                           "launched": timeline.launched, "launch_calls": timeline.launch_calls,
                           "device_records": timeline.device_records}
    result["setup_parts_s"] = {**parts, **getattr(session, "setup_parts", {})}
    result["checks"] = {k: {"value": v, "limit": bounds.get(k)} for k, v in numbers.items()}
    lines = [f"check {k} {v!r} limit {bounds.get(k)!r}" for k, v in numbers.items()]
    return result, lines
