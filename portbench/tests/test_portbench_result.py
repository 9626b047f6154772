"""The result line's keys, the module check by whole top-level names, and
the entry's refusal to run without a card."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT
from portbench.harness import nojax, runner, spec

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]
CELL = spec.benchmark()["workloads"][0]["name"]


def test_result_line_keys(tiny_root):
    for trace in (False, True):
        result, lines = runner.run_cell(spec.cell("tiny.prefill", tiny_root), 3**30, 0.3, trace,
                                        "cpu")
        keys = list(result)
        assert keys[:5] == REQUIRED and keys[-1] == "checks"
        assert set(keys) <= set(REQUIRED) | {"breakdown", "trace", "setup_parts_s", "checks"}
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
        assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
        assert all(set(v) == {"value", "limit"} for v in result["checks"].values())
        assert lines == [f"check {k} {v['value']!r} limit {v['limit']!r}"
                         for k, v in result["checks"].items()]
        if trace:
            assert {"busy_s", "window_s"} <= set(result["device"])
            assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
            assert all(len(v) <= 10 for v in result["breakdown"].values())
            names = {m["name"] for m in spec.cell("tiny.prefill", tiny_root).per_layer}
            assert set(result["metrics"]) <= names
        else:
            assert set(result["metrics"]) == {"prefill_tokens_per_s", "ttft_ms_p95", "setup_s"}
        json.dumps(result)


def test_forbidden_names_compare_whole():
    assert nojax.loaded_forbidden(["repro_torch", "repro_torch.core", "jaxtyping", "reprox"]) == []
    assert nojax.loaded_forbidden(["repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_nothing_of_jax(tiny_root):
    """A whole tiny run in a fresh process, then the modules it loaded."""
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "from pathlib import Path\n"
            "from portbench.harness import runner, spec\n"
            f"root = Path({str(tiny_root)!r})\n"
            "for name in ('tiny.round', 'tiny.prefill'):\n"
            "    runner.run_cell(spec.cell(name, root), 5, 0.2, True, 'cpu')\n"
            "from portbench.harness import nojax\n"
            "print(nojax.loaded_forbidden(), 'portbench.run' not in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_the_entry_refuses_without_a_card(tmp_path):
    """On the CPU the entry prints no result and exits non-zero."""
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          CELL, "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    import torch

    if not torch.cuda.is_available():
        assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_entry_fails_with_only_the_benchmarks_files(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/: no result."""
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL,
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "import portbench.reference.model, portbench.reference.round\n"
            "import portbench.reference.lowp\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'repro_torch', 'repro', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
