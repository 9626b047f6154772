"""The metric readers on hand-made timelines, the libraries found by listing
their folder, and the closed loop's requests and latencies on the CPU."""

from __future__ import annotations

import re
import statistics
import types

import pytest

from conftest import ROOT
from portbench import libraries
from portbench.harness import flops, readers, runner, spec
from portbench.harness import trace as tracing

CFG = {"d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4, "d_ff": 16,
       "vocab_size": 32, "num_layers": 3,
       "lora": {"rank": 2, "targets": ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"]}}
LORA = "void (anonymous namespace)::prefill::kernel<128, 64>(Ops)"


def ctx(launched, forwards=((2, 5),), whole=True, cfg=CFG, device_s=1e-3):
    tl = tracing.Timeline(window_s=1.0, busy_s=device_s, kernels={LORA: [device_s, 21]},
                          idle_by_host={}, whole=whole, launched={"lora_matmul": launched},
                          device_records=21, info={"steps": 1, "forwards": list(forwards)})
    cell = types.SimpleNamespace(config=cfg)
    return types.SimpleNamespace(timeline=tl, cell=cell, window={"steps": [{}], "seconds": 1.0})


def test_libraries_are_the_files_of_their_folder():
    files = sorted(p.stem for p in (ROOT / "portbench" / "libraries").glob("*.py"))
    assert libraries.names() == [f for f in files if f != "__init__"]
    for name in libraries.names():
        lib = libraries.get(name)
        assert isinstance(lib.KERNEL, re.Pattern) and callable(lib.launches)
        assert callable(lib.shapes) and callable(lib.work)


def test_roofline_reads_the_least_time_of_the_counted_launches():
    shapes = libraries.get("lora_matmul").shapes(CFG, 2, 5)
    assert len(shapes) == 21 and shapes[0] == (10, 8, 8, 2)
    least = sum(flops.least_s(*flops.lora_work(*s)) for s in shapes)
    assert readers.roofline_percent(ctx(21), "lora_matmul") == pytest.approx(100 * least / 1e-3)


@pytest.mark.parametrize("case", ["fewer launches", "more launches", "not whole", "no forward",
                                  "another family", "no device time"])
def test_roofline_is_silent_where_it_cannot_read(case):
    c = {"fewer launches": ctx(14), "more launches": ctx(28), "not whole": ctx(21, whole=False),
         "no forward": ctx(0, forwards=()),
         "another family": ctx(21, cfg=dict(CFG, family="mamba2")),
         "no device time": ctx(21, device_s=0.0)}[case]
    assert readers.roofline_percent(c, "lora_matmul") is None


def test_a_trace_is_whole_by_every_librarys_pattern():
    """A third library's pattern counts like the two the port has."""
    ev = [("host", tracing.PART, 0.0, 100.0), ("device", "ssd::kernel<1>", 10.0, 20.0),
          ("device", LORA, 30.0, 40.0), ("host", "cudaLaunchKernel", 5.0, 6.0)]
    pats = {"lora_matmul": libraries.get("lora_matmul").KERNEL,
            "ssd_scan": re.compile(r"ssd::kernel")}
    assert tracing.reduce(ev, {"lora_matmul": 1, "ssd_scan": 1}, {}, pats).whole
    tl = tracing.reduce(ev, {"lora_matmul": 1, "ssd_scan": 2}, {}, pats)
    assert not tl.whole and tl.recorded == {"lora_matmul": 1, "ssd_scan": 1}
    assert tl.busy_s == pytest.approx(20e-6) and tl.window_s == pytest.approx(100e-6)


def test_the_idle_share_is_the_traced_busy_time_against_the_windows_step():
    c = ctx(21, device_s=0.25)
    c.window = {"steps": [{}, {}, {}, {}], "seconds": 2.0}  # 0.5 s a step
    assert readers.idle_percent(c) == pytest.approx(50.0)


def test_the_closed_loop_keeps_every_client_busy(tiny_root):
    """Every batch is full, each request's latency runs from its submission
    (the window's start or its client's last token) to its batch's end."""
    cell = spec.cell("tiny.prefill", tiny_root)
    run = runner.Run(cell, 2**32 + 5, 0.3, runner.torch.device("cpu"))
    from portbench.harness import kinds

    s = kinds.get(cell.traffic["kind"]).Session(run)
    w = s.window(0.3)
    steps, lat = w["steps"], w["latency_s"]
    assert len(steps) > 8 and all(x["requests"] == 2 for x in steps)
    assert w["attempted"] == len(lat) == 2 * len(steps) == len(s.served)
    assert sorted(s.served) == list(range(len(lat)))  # in order, none skipped
    ends = [0.0] + [x["t1"] for x in steps]
    assert lat == pytest.approx([ends[k + 1] - ends[k] for k in range(len(steps))
                                 for _ in range(2)])
    p95 = spec.reader("ttft_ms_p95", tiny_root)(types.SimpleNamespace(window=w))
    assert p95 == pytest.approx(1000 * statistics.quantiles(lat, n=20)[18])


def test_prompts_depend_on_the_seed_alone(tiny_root, monkeypatch):
    cell = spec.cell("tiny.prefill", tiny_root)
    from portbench.harness import kinds

    monkeypatch.setattr(kinds.get(cell.traffic["kind"]), "CHUNK", 8)
    mk = kinds.get(cell.traffic["kind"]).Session
    a = mk(runner.Run(cell, 7, 0.1, runner.torch.device("cpu")))
    b = mk(runner.Run(cell, 7, 0.1, runner.torch.device("cpu")))
    a.window(0.2)  # a draws its chunks in the window, b afterwards
    assert all(bool((a.prompts(i, 2) == b.prompts(i, 2)).all()) for i in range(0, 40, 2))
    with pytest.raises(ValueError):
        a.prompts(7, 2)  # across two chunks of 8
