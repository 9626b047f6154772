"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with tiny
cells added as new files only (configurations, traffic, limits and a metric),
which the harness runs on the CPU with the port's plain paths."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=256)
TIGHT = {"tiny.round": {"loss_gap": 1e-4, "update_gap": 1e-3, "change_gap": 1e-3},
         "tiny.prefill": {"token_gap": 1e-4}, "tiny-bf16.prefill": {"token_gap": 0.05}}


def _dump(obj, path: Path):
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_tiny_root(dest: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ plus tiny cells: ``tiny.round``
    and ``tiny.prefill`` (fp32, untied head), ``tiny-bf16.prefill`` (tied),
    and a dummy per-layer metric ``requests_per_step`` read in the prefill cells."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    pb = dest / "portbench"
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    base = json.loads((pb / "configs" / "fedsllm-100m-fp32lora.json").read_text())
    configs = {"tiny": dict(base, name="tiny", dtype="float32", **TINY),
               "tiny-bf16": dict(base, name="tiny-bf16", tie_embeddings=True, **TINY)}
    for name, c in configs.items():
        _dump(c, pb / "configs" / f"{name}.json")
        spec["configs"].append({"name": name, "source": "https://arxiv.org/abs/2407.09250",
                                "file": f"portbench/configs/{name}.json", "reduced": [],
                                "why": "a CPU test's tiny decoder"})
    rnd = json.loads((pb / "traffic" / "fedsllm_round_k4_32x512.json").read_text())
    _dump(dict(rnd, clients=2, seqs_per_client=2, seq_len=16), pb / "traffic" / "tiny_round.json")
    docs = json.loads((pb / "traffic" / "docs_2x2048_closed.json").read_text())
    _dump(dict(docs, prompt_len=16, check_requests=400),
          pb / "traffic" / "tiny_docs.json")
    cells = [("tiny.round", "tiny", "tiny_round"), ("tiny.prefill", "tiny", "tiny_docs"),
             ("tiny-bf16.prefill", "tiny-bf16", "tiny_docs")]
    for name, config, traffic in cells:
        spec["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                                  "why": "a CPU test's tiny cell"})
        _dump({"limits": TIGHT[name]}, pb / "limits" / f"{name}.json")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            train = any(w.endswith(".round") for w in m["workloads"])
            m["workloads"] += ["tiny.round"] if train else ["tiny.prefill", "tiny-bf16.prefill"]
    spec["per_layer"].append({"name": "requests_per_step", "unit": "requests", "better": "higher",
                              "source": "program_counter", "layer": "entry",
                              "moves": "prefill_tokens_per_s",
                              "workloads": ["tiny.prefill", "tiny-bf16.prefill"]})
    (pb / "metrics" / "requests_per_step.py").write_text(
        "def read(ctx):\n"
        "    steps = ctx.window['steps']\n"
        "    return sum(s['requests'] for s in steps) / len(steps) if steps else None\n")
    _dump(spec, dest / "BENCHMARK.json")
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("portbench"))


@pytest.fixture
def cuda_card():
    """Skips unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
