"""The arithmetic the metric readers share (each metric's reader is a file of
its own in ``metrics/``). A reader that finds nothing to read returns None,
and the metric is left out of the result line."""

from __future__ import annotations

from portbench import libraries
from portbench.harness import flops

GIB = 2 ** 30


def window_s(ctx) -> float:
    return ctx.window["seconds"]


def tokens_per_s(ctx):
    """Every token of the window's finished steps over the window's whole
    length (from its start to the end of its last step)."""
    steps = ctx.window["steps"]
    return sum(s["tokens"] for s in steps) / window_s(ctx) if steps else None


def mfu_percent(ctx):
    """Model FLOPs of the window's finished steps over the window's length at
    the bf16 dense peak, in percent."""
    steps = ctx.window["steps"]
    if not steps:
        return None
    return 100.0 * sum(s["flops"] for s in steps) / (window_s(ctx) * flops.PEAK_BF16)


def idle_percent(ctx):
    """The share of the measured window in which no operation ran on the
    card, in percent: one minus the traced steps' device busy time per step
    (the profiler's timeline) over the window's mean step time (the host's
    clock, over the untraced window). The traced steps do the window's work
    at its shapes; their own length is not the denominator, since the
    profiler slows the host that launches them. Not clamped: a reading under
    0 would say the traced steps kept the card busier than the window's
    steps took, a fault to look for."""
    tl, steps = ctx.timeline, ctx.window["steps"]
    if tl is None or not tl.device_records or not steps or not tl.info.get("steps"):
        return None
    return 100.0 * (1.0 - (tl.busy_s / tl.info["steps"]) / (window_s(ctx) / len(steps)))


def peak_gib(ctx):
    return None if ctx.window_peak_bytes is None else ctx.window_peak_bytes / GIB


def roofline_percent(ctx, library: str):
    """The summed least time of one library's launches in the traced part
    (``portbench/libraries/<library>.py``: its shapes in the part's forward
    passes, its bytes at HBM's rate or its operations at the bf16 peak) over
    their summed device time by kernel name, in percent. None unless the
    trace is whole, holds that library's kernels, and the library's counter
    saw as many launches as the shapes count: a launch fused away, added or
    moved to another library leaves the metric silent, never wrong."""
    tl = ctx.timeline
    if tl is None or not tl.whole:
        return None
    lib = libraries.get(library)
    shapes = []
    for B, S in tl.info.get("forwards", []):
        found = lib.shapes(ctx.cell.config, B, S)
        if found is None:
            return None
        shapes += found
    if not shapes or len(shapes) != tl.launched.get(library):
        return None
    device_s = sum(s for n, (s, _) in tl.kernels.items() if lib.KERNEL.search(n))
    if not device_s:
        return None
    return 100.0 * sum(flops.least_s(*lib.work(shape)) for shape in shapes) / device_s
