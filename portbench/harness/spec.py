"""Find a cell's configuration, traffic mix and metrics by name.

``BENCHMARK.json`` lies at the root of the checkout; the files it names lie
under ``portbench/``: ``configs/<config>.json``, ``traffic/<traffic>.json``
and one reader ``metrics/<metric>.py`` per metric. A later cell or metric is
a new file and a new entry, never an edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent  # portbench/
ROOT = BENCH_DIR.parent  # the checkout


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    chips: int
    end_to_end: tuple  # the metric entries of BENCHMARK.json this cell reports
    per_layer: tuple
    root: Path


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric with ``workloads`` is reported in the cells it lists; one
    without, in every cell (an end-to-end metric) or every cell that reports
    the end-to-end metric it ``moves`` (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, root: Path = ROOT) -> Cell:
    spec = benchmark(root)
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       + ", ".join(w["name"] for w in spec["workloads"]))
    w = found[0]
    conf = [c for c in spec["configs"] if c["name"] == w["config"]]
    if not conf:
        raise KeyError(f"workload {name!r} names config {w['config']!r}, which BENCHMARK.json "
                       "does not list")
    config = load_json(root / conf[0]["file"])
    traffic = load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    e2e = tuple(m for m in spec["end_to_end"] if _reports(m, name, set()))
    names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in spec["per_layer"] if _reports(m, name, names))
    return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer, root)


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    if not path.exists():
        raise KeyError(f"metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
