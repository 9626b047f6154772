"""Runs of tiny cells on the CPU: sound runs come out correct, and each
fault the cells can have, planted in the timed path, and the precision
control in the program's place, come out not correct."""

from __future__ import annotations

import pytest

from portbench.harness import runner, spec
from portbench.reference.lowp import fp8_e4m3

SEED = 2**33 + 11


def run(root, name, trace=False, **kw):
    return runner.run_cell(spec.cell(name, root), SEED, 0.3, trace, "cpu", **kw)[0]


@pytest.mark.parametrize("name", ["tiny.round", "tiny.prefill", "tiny-bf16.prefill"])
def test_sound_runs_are_correct(tiny_root, name):
    assert run(tiny_root, name)["correct"]


@pytest.mark.parametrize("name, fault", [
    ("tiny.round", "unchanged"),  # a step that returns its state unchanged
    ("tiny.round", "half_batch"),  # half of each batch left out, the mean over the rest
    ("tiny.prefill", "token_altered"),  # a served token altered where it is produced
    ("tiny-bf16.prefill", "token_altered"),
])
def test_faults_come_out_not_correct(tiny_root, name, fault):
    assert not run(tiny_root, name, fault=fault)["correct"]


@pytest.mark.parametrize("name", ["tiny.round", "tiny.prefill"])
def test_the_precision_control_comes_out_not_correct(tiny_root, name):
    assert not run(tiny_root, name, control=fp8_e4m3)["correct"]


def test_fp8_rounding_keeps_three_mantissa_bits():
    import torch

    x = torch.tensor([1.0, 1.0625, 1.125, -448.0, 3.0e-3])
    y = fp8_e4m3(x)
    assert y[0] == 1.0 and y[2] == 1.125 and y[3] == -448.0
    assert y[1] in (1.0, 1.125)  # between two e4m3 steps of 1/8
