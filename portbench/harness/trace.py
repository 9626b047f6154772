"""The traced part of a ``--trace 1`` run: torch.profiler over a short stretch
of the cell's own work, reduced to a timeline.

The rule of ``chip_smoke.py``: a trace is kept only when it is whole.
Here whole means that the profiler recorded a device record for every launch
of each of the port's libraries (``portbench/libraries/``) that its counter
saw in the part, and at least as many device kernels as the host's launch
calls it recorded. The profiler
drops records at the ends of its window, so idle host time pads each end,
outside the part's own span. Up to ``TRIES`` parts are traced.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field

TRIES = 3
PAD_S = 0.1
PART = "portbench.traced_part"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")


@dataclass
class Timeline:
    """What the metrics read of a traced part. Times in seconds."""

    window_s: float
    busy_s: float
    kernels: dict  # name -> [seconds, count]
    idle_by_host: dict  # what the host was doing -> idle seconds
    whole: bool
    recorded: dict = field(default_factory=dict)  # port kernel records by library
    launched: dict = field(default_factory=dict)  # port launches by library (counters)
    launch_calls: int = 0
    device_records: int = 0
    info: dict = field(default_factory=dict)  # the session's description of the part


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, points):
    """For each of the increasing ``points``, the name of the host event that
    covers it and started last (the innermost of nested events), or
    "python" where none does. host: (start, end, name) sorted by start."""
    active, out, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] < p:  # ended: ends before every later point too
            heapq.heappop(active)
        out.append(active[0][2] if active else "python")
    return out


def reduce(events, launched: dict, info: dict, patterns: dict) -> Timeline:
    """events: (kind, name, start_us, end_us) with kind "host" or "device";
    the part's span is the host event named ``PART``. ``launched`` and
    ``patterns``: each library's launches by its counter and the pattern of
    its kernels' names."""
    part = [(s, e) for k, n, s, e in events if k == "host" and n == PART]
    if not part:
        raise RuntimeError("the traced part's span is missing from the trace")
    lo, hi = part[0]
    dev = [(n, max(s, lo), min(e, hi)) for k, n, s, e in events
           if k == "device" and n != PART and e > lo and s < hi]  # not the span's own device range
    busy = _union([(s, e) for _, s, e in dev])
    kernels: dict = {}
    for n, s, e in dev:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (e - s) * 1e-6
        k[1] += 1
    host = sorted((s, e, n) for k, n, s, e in events
                  if k == "host" and n != PART and e > lo and s < hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    idle: dict = {}
    for (s, e), name in zip(gaps, _innermost(host, [(s + e) / 2 for s, e in gaps])):
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    recorded = {lib: sum(c for n, (_, c) in kernels.items() if pattern.search(n))
                for lib, pattern in patterns.items()}
    calls = sum(1 for k, n, s, e in events if k == "host" and n in LAUNCH_CALLS and lo <= s <= hi)
    records = sum(c for _, c in kernels.values())
    whole = bool(dev) and all(recorded[k] == launched.get(k, 0) for k in recorded) \
        and records >= calls
    return Timeline((hi - lo) * 1e-6, sum(e - s for s, e in busy) * 1e-6, kernels, idle, whole,
                    recorded, dict(launched), calls, records, info)


def _events(prof):
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        kind = "device" if e.device_type == DeviceType.CUDA else "host"
        out.append((kind, e.name, float(e.time_range.start), float(e.time_range.end)))
    return out


def trace_part(part, libs: dict, sync, cuda: bool) -> Timeline:
    """Trace ``part()`` (which returns the session's description of its work)
    until a trace is whole, ``TRIES`` at most; the last one is returned.
    ``libs``: the library modules by name (``portbench.libraries.load()``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tl = None
    for _ in range(TRIES):
        sync()
        before = {k: lib.launches() for k, lib in libs.items()}
        with profile(activities=acts) as prof:
            time.sleep(PAD_S)
            with record_function(PART):
                info = part()
                sync()
            time.sleep(PAD_S)
        launched = {k: lib.launches() - before[k] for k, lib in libs.items()}
        tl = reduce(_events(prof), launched, info, {k: lib.KERNEL for k, lib in libs.items()})
        if tl.whole or not cuda:
            break
    return tl


def breakdown(tl: Timeline) -> dict:
    ops = sorted(((n, s) for n, (s, _) in tl.kernels.items()), key=lambda x: -x[1])[:10]
    gaps = sorted(tl.idle_by_host.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n[:120], s] for n, s in gaps]}
