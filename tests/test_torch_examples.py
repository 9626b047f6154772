"""The port's examples (``repro_torch.examples``) run on the CPU through
their ``main`` with ``--device cpu``, as a user runs them with ``python -m``.
``fedsllm_end_to_end`` (four allocator solves for 50 clients and an 8-round
campaign, ~40 s here) is left to the card's smoke run; its parts are held to
the reference in ``test_torch_alloc.py`` and ``test_torch_experiment.py``."""

import math

import torch

from repro_torch.examples import quickstart, resource_allocation_demo, serve_demo


def test_quickstart_trains_decodes_and_runs_a_round(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert out["last_loss"] < out["first_loss"]  # the structured stream is learnable
    assert out["generated"].shape == (2, 8) and out["generated"].dtype == torch.int64
    res = out["round"]
    assert all(math.isfinite(float(v)) for v in res.metrics.values())
    assert res.wall_clock > 0
    assert "federated round via Experiment" in capsys.readouterr().out


def test_serve_demo_serves_the_ported_families(capsys):
    out = serve_demo.main(["--device", "cpu"])
    assert set(out) == {"fedsllm-100m", "mamba2-130m"}
    assert all(tokens.shape == (4, 12) for tokens in out.values())
    printed = capsys.readouterr().out
    assert "recurrentgemma-9b" in printed and "not ported yet" in printed


def test_resource_allocation_demo_runs():
    reductions = resource_allocation_demo.main(["--device", "cpu"])
    assert len(reductions) == 3 and all(0 < r < 1 for r in reductions)
