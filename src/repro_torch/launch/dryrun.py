"""Dry-run: plan every (arch x shape) cell on the meta device and measure it
on the card (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's full step on 512 placeholder
TPU devices and reads XLA's cost and memory analyses. Its counterpart for one
card has two halves:

* ``plan_cell`` builds the cell's parameters, adapters, cache, batch and
  (train) optimizer state on the meta device at full depth, and runs the
  step there: nothing is allocated, nothing launched. It records the
  resident bytes by part; ``flops``, the step's products as
  ``torch.utils.flop_counter.FlopCounterMode`` counts them on the plain path
  (``kernels=False``: ``_attend_full`` over the whole Sq x Skv rectangle,
  causal or windowed alike, as the reference's HLO counts it;
  ``ssd_chunked``; the MoE dispatch with its capacity padding; LoRA through
  ``lora_matmul``'s plain version; train steps through ``make_train_step``'s
  autograd, remat included); ``bytes_unfused``, the operand and result bytes
  of every aten op that moves data (a ceiling: the kernels fuse), and of it
  ``s2_bytes``, the score-shaped tensors (rank >= 5 with both trailing dims
  >= 256, and the rank-3 products of the same size and last dim that
  ``einsum`` computes them as), which flash never writes; ``model_flops``
  (6·N_active·tokens for train, 2·N_active·tokens for prefill, 2·N_active·B
  for decode, as ``benchmarks/roofline.py`` defines it) and its ratio to
  ``flops``; the output bytes; and ``plain_at_peak_ms``, the larger of
  ``flops`` at the card's bf16 peak and ``bytes_unfused - s2_bytes`` at its
  memory rate. That is the plain path's counted work at the card's peaks,
  not a lower bound on the step: it counts the masked part of every score
  rectangle and the MoE capacity padding, which the kernels and a tighter
  dispatch do not need (qwen3-moe-235b-a22b x decode_32k: 86 times its
  model FLOPs), so no roofline share is to be read from it.
  ``collectives`` are zero bytes: one card. The reference's HLO parsers
  (``parse_collectives``, ``parse_s2_traffic``) read XLA text, which the
  port never produces, and are not ported.
* ``measure_cell`` runs the step on the card at full width and at the
  reference's calibration depths, M1 (one layer group), M2 (two) and, where
  the config has a tail, M1t (one group and the tail), the encoder's depth
  unchanged, at the largest power-of-two batch b <= the cell's global batch
  whose M2 fits the card, reckoned from the plan's bytes per row and M1's
  measured transient at b = 1. Each run records CUDA-event ms (median of 3
  after a warm-up), ``torch.cuda.max_memory_allocated`` above the resident
  bytes, and each kernel's launches by variant. ``compose_costs`` (the
  reference's: stem + n_groups·per_group + tail, each term clamped at 0)
  composes ms and transient bytes at full depth; the result is then scaled
  linearly from b to the global batch, an extrapolation the record names.

Serve steps run under ``torch.inference_mode()`` with LoRA adapters
unmerged; the plan takes the plain path, the measurement the kernels.
``fits`` and ``max_batch`` (at full depth) hold the plan's resident and
output bytes, and with a measurement its composed transient, against
``torch.cuda.get_device_properties(0).total_memory`` of the card that runs
the CLI; on the CPU they are None. Cells are ``all_cells()``: every arch but
fedsllm-100m x ``SHAPES``; a full-attention arch's ``long_500k`` cell is a
documented skip, with the reference's reason.

Records go to ``results/dryrun_torch/<arch>__<shape>.json``, incrementally
(an existing cell is skipped unless ``--force``); never to the reference's
``results/dryrun/``.

Usage:
  python -m repro_torch.launch.dryrun --all --device cpu        # plan only
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape prefill_32k --measure
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import glob
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import (SHAPES, ModelConfig, ShapeConfig, TrainConfig, get_arch,
                                list_archs, shape_applicable)
from repro_torch.core.lora import init_lora
from repro_torch.device import resolve_device
from repro_torch.kernels.attn_ops import flash_attention
from repro_torch.kernels.lora_ops import lora_matmul
from repro_torch.kernels.ssd_ops import ssd_scan
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.models.registry import active_param_count, count_params
from repro_torch.tree import tree_leaves

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
RESULTS_DIR = os.path.join(REPO, "results", "dryrun_torch")
REFERENCE_DIR = os.path.join(REPO, "results", "dryrun")  # the reference's: never written

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 bandwidth
PEAKS = "NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16, 3.35 TB/s"
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
S2_THRESHOLD = 256
SKIP_REASON = "full-attention arch at 500k context (DESIGN.md §5)"
TIMED_RUNS = 3
# of the card's memory that a measured run may plan to take: the rest is the
# allocator's (at 0.85, olmoe-1b-7b x prefill_32k's M2 at b=8 ran out with
# 22.8 GiB reserved but unallocated on an H100 80GB)
FIT_SHARE = 0.7
KERNELS = {"lora_matmul": lora_matmul, "flash_attention": flash_attention, "ssd_scan": ssd_scan}

# aten ops that move no data: views, aliases and allocations
_FREE = {"_unsafe_view", "alias", "detach", "lift_fresh", "empty", "empty_strided",
         "empty_like", "new_empty", "new_empty_strided", "_local_scalar_dense"}


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class Traffic(TorchDispatchMode):
    """Operand and result bytes of every aten op that moves data (each tensor
    once per op), and of them the score-shaped ones (``s2``)."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_key: collections.Counter = collections.Counter()
        self.s2_keys: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket.__name__ in _FREE:
            return out
        seen = {}
        for t in tree_leaves((list(args), dict(kwargs or {}),
                              list(out) if isinstance(out, (tuple, list)) else [out])):
            if isinstance(t, torch.Tensor):
                seen[id(t)] = t
        for t in seen.values():
            n = t.numel() * t.element_size()
            key = (t.numel(), t.shape[-1] if t.ndim else 0)
            self.total += n
            self.by_key[key] += n
            if t.ndim >= 5 and min(t.shape[-2:]) >= S2_THRESHOLD:
                self.s2_keys.add(key)
        return out

    @property
    def s2(self) -> int:
        """Bytes of the tensors shaped as a score tensor: a rank >= 5 tensor
        with both trailing dims >= ``S2_THRESHOLD``, or any tensor of its
        element count and last dim (the batched product ``einsum`` computes
        it as)."""
        return sum(self.by_key[k] for k in self.s2_keys)


def model_flops(kind: str, n_active: int, seq_len: int, batch: int) -> float:
    """``benchmarks/roofline.py``'s MODEL_FLOPS of one step."""
    if kind == "train":
        return 6.0 * n_active * seq_len * batch
    if kind == "prefill":
        return 2.0 * n_active * seq_len * batch
    return 2.0 * n_active * batch


def at_peak_ms(flops: float, nbytes_: float) -> tuple[float, str]:
    """The card's time for ``flops`` bf16 products and ``nbytes_`` of
    traffic at its peaks, and which of the two sets it."""
    t_ops, t_bytes = flops / PEAK_BF16, nbytes_ / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# A cell's state and step
# ---------------------------------------------------------------------------


def with_batch(shape: ShapeConfig, batch: Optional[int]) -> ShapeConfig:
    return shape if batch is None else dataclasses.replace(shape, global_batch=int(batch))


def build_step(cfg: ModelConfig, shape: ShapeConfig, device, *, seed: int = 0,
               kernels: bool = True):
    """The cell's resident state by part ({params, lora, opt_state, cache,
    batch}; absent parts None) and the step as a function of nothing. On
    the meta device everything is a shape; elsewhere the weights are drawn
    from ``seed`` and the inputs from ``SP.concrete_like``. Train: the full
    parameters through ``make_train_step`` (the reference's dry-run trains
    no adapter); prefill and decode: the adapters unmerged through
    ``T.prefill`` / ``T.decode_step`` at position S - 1 (``kernels`` picks
    the prefill's attention and scan)."""
    device = torch.device(device)
    meta = device.type == "meta"
    specs = SP.cell_specs(cfg, shape)
    params = T.init_params(cfg, seed=seed, device=device)
    parts: dict[str, Any] = {"params": params, "lora": None, "opt_state": None,
                             "cache": None, "batch": None}
    if shape.kind == "train":
        step_fn, opt = ST.make_train_step(cfg, TrainConfig())
        opt_state = ST.abstract_opt_state(opt, params) if meta else opt.init(params)
        batch = specs if meta else SP.concrete_like(specs, seed=seed + 2, device=device)
        step = torch.zeros((), dtype=torch.int32, device=device)
        parts.update(opt_state=opt_state, batch=batch)
        return parts, lambda: step_fn(params, opt_state, step, batch)
    lora = init_lora(params, cfg, seed=seed + 1, device=device)
    parts["lora"] = lora
    if shape.kind == "prefill":
        cache = SP.cache_specs(cfg, shape) if meta else \
            T.init_cache(cfg, shape.global_batch, shape.seq_len, device=device)
        batch = specs if meta else SP.concrete_like(specs, seed=seed + 2, device=device)
        parts.update(cache=cache, batch=batch)
        return parts, lambda: T.prefill(params, batch, cfg, cache, lora=lora, kernels=kernels)
    inputs = specs if meta else SP.concrete_like(specs, seed=seed + 2, device=device)
    cache, pos = inputs.pop("cache"), shape.seq_len - 1
    parts.update(cache=cache, batch=inputs)
    return parts, lambda: T.decode_step(params, inputs["tokens"], cache, pos, cfg, lora=lora,
                                        enc_out=inputs.get("enc_out"))


def resident_bytes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The cell's resident bytes by part, from its state on the meta device."""
    parts, _ = build_step(cfg, shape, "meta", kernels=False)
    return {k: nbytes(v) for k, v in parts.items()}


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under a tree's tensors."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            seen[(s.data_ptr(), s.nbytes())] = s.nbytes()
    return sum(seen.values())


def _step_mode(shape: ShapeConfig):
    return torch.inference_mode() if shape.kind != "train" else torch.enable_grad()


def plan_cell(cfg: ModelConfig, shape: ShapeConfig, batch: Optional[int] = None) -> dict:
    """Resident bytes by part, FLOPs, traffic and the plain path's time at
    the card's peaks of one step of the cell on the meta device (see the module docstring); ``batch`` replaces
    the shape's global batch."""
    shape = with_batch(shape, batch)
    t0 = time.perf_counter()
    parts, step = build_step(cfg, shape, "meta", kernels=False)
    resident = {k: nbytes(v) for k, v in parts.items()}
    inputs = {id(t) for t in tree_leaves(parts) if isinstance(t, torch.Tensor)}
    flop_counter, traffic = FlopCounterMode(display=False), Traffic()
    with _step_mode(shape), flop_counter, traffic:
        out = step()
    outputs = nbytes([t for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor) and id(t) not in inputs])
    flops = float(flop_counter.get_total_flops())
    n_active = active_param_count(cfg)
    mf = model_flops(shape.kind, n_active, shape.seq_len, shape.global_batch)
    p_ms, p_by = at_peak_ms(flops, traffic.total - traffic.s2)
    return {"batch": shape.global_batch, "resident_bytes": resident,
            "resident_total": sum(resident.values()), "output_bytes": outputs,
            "flops": flops, "model_flops": mf, "model_flops_ratio": mf / flops if flops else None,
            "bytes_unfused": float(traffic.total), "s2_bytes": float(traffic.s2),
            "plain_at_peak_ms": p_ms, "plain_at_peak_by": p_by, "peaks": PEAKS,
            "collectives": {"bytes": 0, "note": "one card"},
            "plan_seconds": time.perf_counter() - t0}


def fixed_and_per_row(plan: dict, kind: str) -> tuple[float, float]:
    """A plan's bytes that do not scale with the batch (weights, adapters,
    optimizer state; a train step's outputs, the new weights and state) and
    its bytes per row (cache and batch; a serve step's outputs, the logits):
    each part is one or the other, exactly."""
    r = plan["resident_bytes"]
    fixed = r["params"] + r["lora"] + r["opt_state"]
    rows = r["cache"] + r["batch"]
    if kind == "train":
        fixed += plan["output_bytes"]
    else:
        rows += plan["output_bytes"]
    return float(fixed), rows / plan["batch"]


def max_batch(fixed: float, per_row: float, memory: float) -> int:
    return max(int((memory - fixed) // per_row), 0)


# ---------------------------------------------------------------------------
# Measurement on the card
# ---------------------------------------------------------------------------


def _counts() -> dict:
    return {n: dict(fn.variant_launches) for n, fn in KERNELS.items()}


def _zero_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        for k in fn.variant_launches:
            fn.variant_launches[k] = 0


def run_on_card(cfg: ModelConfig, shape: ShapeConfig, device, *, timed: int = TIMED_RUNS,
                seed: int = 0) -> dict:
    """One step of the config at the shape's batch on the card: the bytes
    its state takes (tensor bytes, their storages' and the allocator's), a
    warm-up counted for launches by variant (``launches``; every call's in
    ``launches_total``), then ``timed`` calls timed by CUDA events (the
    median), and the peak allocated above the resident state."""
    dev = torch.device(device)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    parts, step = build_step(cfg, shape, dev, seed=seed)
    torch.cuda.synchronize(dev)
    allocated = torch.cuda.memory_allocated(dev) - base
    resident = {k: nbytes(v) for k, v in parts.items()}
    storages = storage_bytes(parts)
    torch.cuda.reset_peak_memory_stats(dev)
    with _step_mode(shape):
        _zero_counts()
        out = step()
        del out
        launches = _counts()
        ms = []
        for _ in range(timed):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step()
            end.record()
            del out
            end.synchronize()
            ms.append(start.elapsed_time(end))
    launches_total = _counts()
    transient = torch.cuda.max_memory_allocated(dev) - base - allocated
    del parts, step
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "batch": shape.global_batch,
            "ms": statistics.median(ms) if ms else None, "ms_runs": ms,
            "transient_bytes": float(transient), "resident_bytes": resident,
            "resident_total": sum(resident.values()), "storage_bytes": storages,
            "allocated_bytes": allocated, "launches": launches,
            "launches_total": launches_total, "calls": 1 + timed}


def calibration_depths(cfg: ModelConfig) -> dict[str, int]:
    """The reference's calibration depths: M1 = one group, M2 = two, M1t =
    one group and the tail (where the depth is not a multiple of the group)."""
    gs, rem = cfg.group_size, cfg.num_layers % cfg.group_size
    out = {"m1": gs, "m2": 2 * gs}
    if rem:
        out["m1t"] = gs + rem
    return out


def measure_batch(cfg: ModelConfig, shape: ShapeConfig, transient_row: float,
                  memory: float) -> int:
    """The largest power of two b <= the global batch for which M2 (its
    weights, adapters and optimizer state, plus b rows of its cache and
    batch and of M1's transient at b = 1, which holds the outputs) fits
    ``FIT_SHARE`` of ``memory``; 0 if even b = 1 does not."""
    m2 = cfg.replace(num_layers=calibration_depths(cfg)["m2"])
    r = resident_bytes(m2, with_batch(shape, 1))
    fixed, row = r["params"] + r["lora"] + r["opt_state"], r["cache"] + r["batch"]
    b = 1
    while 2 * b <= shape.global_batch:
        b *= 2
    while b >= 1 and fixed + b * (row + transient_row) > FIT_SHARE * memory:
        b //= 2
    return b


def measure_cell(cfg: ModelConfig, shape: ShapeConfig, device="cuda", *,
                 batch: Optional[int] = None, full_depth: bool = False) -> dict:
    """The cell's step measured on the card at depths M1, M2 (and M1t) and
    composed to full depth and to the global batch (module docstring).
    ``batch`` fixes b; ``full_depth`` also measures the full-depth step at b
    (the composition's check). Where M1 at b = 1 cannot fit by the plan's
    resident and output bytes, or M2 by ``measure_batch``, nothing runs and
    ``fits`` is False; a run that still exhausts the card's memory is
    recorded as such (``error``). Raises without a card."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"measure_cell needs a CUDA card (device {device!r}; available: "
                           f"{torch.cuda.is_available()})")
    t0 = time.perf_counter()
    memory = torch.cuda.get_device_properties(dev).total_memory
    depths = calibration_depths(cfg)
    rec: dict[str, Any] = {"depths": depths, "memory_bytes": memory,
                           "device": torch.cuda.get_device_name(dev), "fits": True}
    m1_cfg = cfg.replace(num_layers=depths["m1"])
    try:
        if batch is None:
            fixed, row = fixed_and_per_row(plan_cell(m1_cfg, shape, 1), shape.kind)
            if fixed + row > FIT_SHARE * memory:
                rec.update(fits=False, b=0, reason=f"M1 at b=1 holds {(fixed + row) / 1e9:.1f} "
                           f"GB of state and outputs by the plan, over {FIT_SHARE} of the card")
                return rec
            probe = run_on_card(m1_cfg, with_batch(shape, 1), dev, timed=0)
            rec["probe_b1"] = probe
            batch = measure_batch(cfg, shape, probe["transient_bytes"], memory)
        rec["b"] = batch
        if batch < 1:
            rec.update(fits=False, reason=f"M2 at b=1 over {FIT_SHARE} of the card, with M1's "
                       f"transient")
            return rec
        sb = with_batch(shape, batch)
        for name, layers in depths.items():
            rec[name] = run_on_card(cfg.replace(num_layers=layers), sb, dev)
        if full_depth:
            rec["full"] = run_on_card(cfg, sb, dev)
    except torch.cuda.OutOfMemoryError as e:
        rec.update(fits=False, error=f"OutOfMemoryError: {str(e)[:300]}")
    if "error" in rec:  # the failed run's tensors are free once its traceback is
        torch.cuda.empty_cache()
        return rec
    rec["composed"] = compose_costs(rec, cfg)
    scale = shape.global_batch / batch
    rec["at_global_batch"] = {
        "ms": rec["composed"]["ms"] * scale,
        "transient_bytes": rec["composed"]["transient_bytes"] * scale,
        "scale": scale, "extrapolated": scale != 1.0,
        "note": "composed at b, scaled linearly to the global batch" if scale != 1.0
        else "composed at the global batch"}
    rec["measure_seconds"] = time.perf_counter() - t0
    return rec


def compose_costs(rec: dict, cfg: ModelConfig) -> dict:
    """total = stem + n_groups·per_group + tail, for ``ms`` and
    ``transient_bytes`` (the reference's): per_group = M2 - M1, stem = M1 -
    per_group, tail = M1t - M1, each clamped at 0."""
    n_groups = cfg.num_groups
    out = {}
    for key in ("ms", "transient_bytes"):
        c1, c2 = rec["m1"][key], rec["m2"][key]
        per_group = max(c2 - c1, 0.0)
        stem = max(c1 - per_group, 0.0)
        tail = max(rec["m1t"][key] - c1, 0.0) if "m1t" in rec else 0.0
        out[key] = stem + n_groups * per_group + tail
        out[key + "_per_group"] = per_group
        out[key + "_stem"] = stem
    return out


# ---------------------------------------------------------------------------
# Cells and the CLI
# ---------------------------------------------------------------------------


def all_cells():
    for arch in list_archs():
        if arch == "fedsllm-100m":
            continue  # example model, not an assigned cell
        for shape_name in SHAPES:
            yield arch, shape_name


def run_cell(arch: str, shape_name: str, *, device="cuda", measure: bool = False,
             out_dir: str = RESULTS_DIR, force: bool = False) -> dict:
    """Plan (and with ``measure``, measure) one cell; write and return its
    record. An existing record is returned as it is unless ``force``."""
    if os.path.realpath(out_dir) == os.path.realpath(REFERENCE_DIR):
        raise ValueError(f"{out_dir} holds the reference's dry-run records; write elsewhere")
    if measure and torch.device(device).type != "cuda":
        raise ValueError("--measure needs --device cuda")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    dev = resolve_device(device)
    cfg, shape = get_arch(arch), SHAPES[shape_name]
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name, "kind": shape.kind,
                           "seq_len": shape.seq_len, "global_batch": shape.global_batch}
    if not shape_applicable(arch, shape_name):
        rec.update(skipped=True, reason=SKIP_REASON)
    else:
        rec.update(skipped=False, params_total=count_params(cfg),
                   params_active=active_param_count(cfg), num_groups=cfg.num_groups,
                   group_size=cfg.group_size)
        t0 = time.perf_counter()
        try:
            rec["plan"] = plan_cell(cfg, shape)
            fixed, row = fixed_and_per_row(rec["plan"], shape.kind)
            rec["plan"].update(fixed_bytes=fixed, bytes_per_row=row)
            if measure:
                rec["measured"] = measure_cell(cfg, shape, dev)
            if dev.type == "cuda":
                memory = torch.cuda.get_device_properties(dev).total_memory
                at = rec.get("measured", {}).get("at_global_batch")
                counts = "plan: resident and output bytes"
                if at:  # the measured transient holds the outputs and temporaries
                    r = rec["plan"]["resident_bytes"]
                    fixed = r["params"] + r["lora"] + r["opt_state"]
                    row = (r["cache"] + r["batch"] + at["transient_bytes"]) / shape.global_batch
                    counts = "plan's resident bytes + measured transient, scaled per row"
                mb = max_batch(fixed, row, memory)
                rec.update(memory_bytes=memory, device=torch.cuda.get_device_name(dev),
                           card=card(), max_batch=mb, fits=mb >= shape.global_batch,
                           fit_counts=counts)
            else:
                rec.update(memory_bytes=None, max_batch=None, fits=None)
            rec["ok"] = True
        except Exception as e:  # a failing cell is recorded, as in the reference
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        rec["wall_seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def card() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them (None
    where it cannot be asked)."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _gb(x) -> str:
    return "—" if x is None else f"{x / 1e9:.2f}"


def table(out_dir: str = RESULTS_DIR) -> str:
    """The records of ``out_dir`` as a markdown table, one row per cell:
    resident GB by part, fits and max_batch, the plan's FLOPs, model FLOPs
    and their ratio, unfused and score bytes, and the measured b with the
    composed ms at b and scaled to the global batch."""
    cols = ["arch × shape", "params / lora / opt / cache / batch GB", "fits (max_batch)",
            "flops", "model_flops (ratio)", "bytes_unfused / s2", "b", "ms at b",
            "ms at B (scaled)", "card"]
    rows = ["| " + " | ".join(cols) + " |", "|" + "---|" * len(cols)]
    for path in sorted(glob.glob(os.path.join(out_dir, "*__*.json"))):
        with open(path) as f:
            rec = json.load(f)
        cells = [f"{rec['arch']} × {rec['shape']}"] + ["—"] * (len(cols) - 1)
        if rec.get("skipped") or not rec.get("ok"):
            cells[1] = f"skipped: {rec['reason']}" if rec.get("skipped") else \
                f"failed: {rec.get('error', '')[:80]}"
            rows.append("| " + " | ".join(cells) + " |")
            continue
        p, m = rec["plan"], rec.get("measured") or {}
        r = p["resident_bytes"]
        cells[1] = " / ".join(_gb(r[k]) for k in ("params", "lora", "opt_state", "cache",
                                                  "batch"))
        if rec.get("fits") is not None:
            cells[2] = f"{'yes' if rec['fits'] else 'no'} ({rec['max_batch']})"
        cells[3] = f"{p['flops']:.3g}"
        cells[4] = f"{p['model_flops']:.3g} ({p['model_flops_ratio']:.2f})"
        cells[5] = f"{p['bytes_unfused']:.3g} / {p['s2_bytes']:.3g}"
        if not m:
            cells[6] = "not measured"
        elif not m.get("fits", True):
            cells[6] = f"does not fit: {(m.get('reason') or m.get('error', ''))[:60]}"
        else:
            cells[6] = str(m["b"])
            cells[7] = f"{m['composed']['ms']:.1f}"
            cells[8] = f"{m['at_global_batch']['ms']:.0f}"
        cells[9] = rec.get("card") or "—"
        rows.append("| " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--measure", action="store_true", help="measure on the card too")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cpu: plan only (fits and max_batch are None)")
    ap.add_argument("--out", type=str, default=RESULTS_DIR)
    ap.add_argument("--table", action="store_true",
                    help="print the records of --out as a markdown table and stop")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return 0
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    failed = 0
    for arch, shape_name in cells:
        t0 = time.perf_counter()
        rec = run_cell(arch, shape_name, device=args.device, measure=args.measure,
                       out_dir=args.out, force=args.force)
        status = "SKIP" if rec.get("skipped") else ("OK" if rec.get("ok") else "FAIL")
        print(f"[{status}] {arch} x {shape_name}  ({time.perf_counter() - t0:.1f}s)",
              flush=True)
        if status == "FAIL":
            failed += 1
            print(rec.get("error"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
