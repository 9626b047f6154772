"""BENCHMARK.json against the benchmark's contract, and the harness finding
every configuration, traffic mix, limit file and metric by name."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT
from portbench.harness import runner, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
B = spec.benchmark()
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"] and B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_exactly_the_contracts_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        assert m["bound"] >= 0.01
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in B["end_to_end"]} and m["source"] in SOURCES
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                 "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    names = [x["name"] for x in B["configs"] + B["workloads"] + B["end_to_end"] + B["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in B["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_is_found_by_name(name):
    cell = spec.cell(name)
    assert cell.traffic["kind"] in ("fedsllm_round", "prefill_closed_loop")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)
    assert set(runner.limits(cell))
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_configuration_files_hold_what_is_run():
    for c in B["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert all(k in conf for k in c["reduced"])  # each changed key, as run
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])


def test_an_unknown_name_raises_with_the_known_ones():
    with pytest.raises(KeyError, match="fedsllm-100m-fp32lora.round"):
        spec.cell("no-such-cell")
    with pytest.raises(KeyError, match="no reader"):
        spec.reader("no_such_metric")


def test_a_dummy_cell_and_metric_added_as_files_run(tiny_root):
    """New files and new entries only: the harness finds and runs them."""
    cell = spec.cell("tiny.prefill", tiny_root)
    assert "requests_per_step" in {m["name"] for m in cell.per_layer}
    result, lines = runner.run_cell(cell, 2**33 + 7, 0.3, True, "cpu")
    assert result["correct"], lines
    assert result["metrics"]["requests_per_step"]["value"] == 2.0
    assert "mfu.prefill" in result["metrics"]
