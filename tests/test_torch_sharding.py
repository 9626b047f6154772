"""The port's one-card mesh and sharding rules (``repro_torch.launch.mesh``,
``repro_torch.parallel.sharding``) against the reference's
(``repro.launch.mesh``, ``repro.parallel.sharding``), on abstract meshes."""

import pytest
from hypothesis import given, settings, strategies as st

from repro.launch import mesh as RM
from repro.parallel import sharding as RS
from repro_torch.launch import mesh as PM
from repro_torch.parallel import sharding as PS

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "data8": ((8,), ("data",)),
          "one": ((1, 1), ("data", "model"))}
LOGICAL = sorted(RS.RULESETS["train"]) + [None, "unknown"]
DIMS = [1, 2, 3, 8, 16, 24, 32, 36, 48, 128, 256, 512, 4096, 4608, 18432, 32768]


def both(shape, axes, kind, mesh_key):
    """(port spec, reference spec as a tuple) on the same abstract mesh."""
    m_shape, m_axes = MESHES[mesh_key]
    port = PS.spec_for(shape, axes, PS.RULESETS[kind], PM.make_abstract_mesh(m_shape, m_axes))
    ref = RS.spec_for(shape, axes, RS.RULESETS[kind], RM.make_abstract_mesh(m_shape, m_axes))
    return port, tuple(ref)


def test_rulesets_equal_the_reference():
    assert PS.RULESETS == RS.RULESETS
    for kind in RS.RULESETS:
        assert PS.activation_rules(kind) == RS.activation_rules(kind)


# every case of tests/test_sharding.py: (shape, logical axes, rule set, mesh, expected)
REFERENCE_CASES = [
    ((4096, 18432), ("embed", "mlp"), "train", "pod16x16", ("data", "model")),
    ((4608, 36 * 128), ("embed", "heads"), "train", "pod16x16", ("data", "model")),
    ((16, 128, 36, 128), ("batch", "seq", "heads", None), "train", "pod16x16", ("data",)),
    ((256, 256, 256), ("embed", "embed", "embed"), "train", "pod16x16", ("data",)),
    ((256, 4096), ("batch", "seq"), "train", "pod16x16", ("data",)),
    ((256, 4096), ("batch", "seq"), "train", "multipod", (("pod", "data"),)),
    ((128, 32768, 8, 128), ("batch", "kv_seq", "kv_heads", None), "decode", "pod16x16",
     ("data", "model")),
    ((8,), ("embed",), "train", "pod16x16", None),
]


@pytest.mark.parametrize("shape,axes,kind,mesh_key,expected", REFERENCE_CASES)
def test_spec_for_matches_reference_cases(shape, axes, kind, mesh_key, expected):
    port, ref = both(shape, axes, kind, mesh_key)
    assert port == ref
    if expected is not None:
        assert port == expected
    else:
        assert len(port) <= 1


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from(DIMS), min_size=1, max_size=5),
       st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=5),
       st.sampled_from(sorted(RS.RULESETS)), st.sampled_from(sorted(MESHES)))
def test_spec_for_sweep_matches_reference(dims, axes, kind, mesh_key):
    port, ref = both(tuple(dims), tuple(axes), kind, mesh_key)
    assert port == ref, (dims, axes, kind, mesh_key)
    named = [a for entry in port if entry is not None
             for a in (entry if isinstance(entry, tuple) else (entry,))]
    assert len(named) == len(set(named))  # no mesh axis reused across dims
    assert not port or port[-1] is not None  # trailing Nones stripped


def test_one_card_mesh_places_everything_whole():
    mesh = PM.make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1} and mesh.size == 1 and len(mesh.devices) == 1
    one = PM.make_mesh((1, 1), ("data", "model"), device="cpu")
    for kind in PS.RULESETS:
        spec = PS.spec_for((4096, 18432), ("embed", "mlp"), PS.RULESETS[kind], one)
        # size-1 axes divide everything: the tensor is whole on the one card
        assert all(a in ("data", "model", None) for a in spec)


def test_multi_device_mesh_raises():
    with pytest.raises(NotImplementedError, match="one card"):
        PM.make_mesh((16, 16), ("data", "model"), device="cpu")
    with pytest.raises(NotImplementedError, match="one card"):
        PM.make_mesh((2,), ("data",), device="cpu")
    with pytest.raises(ValueError):
        PM.make_abstract_mesh((2, 2), ("data",))


def test_shard_is_the_identity_and_contexts_nest():
    import torch

    x = torch.arange(6.0).reshape(2, 3)
    mesh = PM.make_host_mesh(device="cpu")
    assert PS.active_context() == (None, None)
    assert PS.shard(x, ("batch", "embed")) is x
    with PS.sharding_context(mesh, PS.RULESETS["train"]):
        assert PS.active_context() == (mesh, PS.RULESETS["train"])
        assert PS.shard(x, ("batch", "embed")) is x
        abstract = PM.make_abstract_mesh((16, 16), ("data", "model"))
        with PS.sharding_context(abstract, PS.RULESETS["decode"]):
            assert PS.active_context() == (abstract, PS.RULESETS["decode"])
        assert PS.active_context() == (mesh, PS.RULESETS["train"])
    assert PS.active_context() == (None, None)
    PS.set_context(mesh, PS.RULESETS["prefill"])
    try:
        assert PS.active_context() == (mesh, PS.RULESETS["prefill"])
    finally:
        PS.set_context(None, None)


def test_mesh_import_touches_no_device():
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import torch, repro_torch.launch.mesh, repro_torch.parallel.sharding, "
            "repro_torch.launch.dryrun\n"
            "print(torch.cuda.is_initialized(), 'XLA_FLAGS' in __import__('os').environ)")
    env = {k: v for k, v in __import__("os").environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(root / "src")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]
