"""The port's serving slice against the reference's serve path.

``smoke_variant(fedsllm-100m)`` in fp32 (2 layers), reference parameters and
non-zero adapters bridged through ``repro_torch.bridge``. The reference
serves ``lora.merge(base, lora)`` with jnp attention; the port serves the
base with its adapters unmerged, through the kernels' plain versions on the
CPU. Both compute the same function: fp32 tolerance 1e-4.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import smoke_variant as jax_smoke_variant
from repro.core import lora as jax_lora
from repro.models import transformer as JT
from repro.serving.decode import decode_tokens as jax_decode_tokens
from repro_torch.bridge import lora_from_numpy, params_from_numpy
from repro_torch.config import get_arch, smoke_variant
from repro_torch.core import lora as torch_lora
from repro_torch.models import transformer as T
from repro_torch.serving.decode import decode_tokens

B, S, NEW = 2, 16, 6
TOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_variant(jax_get_arch("fedsllm-100m"))
    cfg = smoke_variant(get_arch("fedsllm-100m"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)  # configs copied verbatim
    jparams, axes = JT.init_params(jcfg, key=jax.random.PRNGKey(0))
    jl, _ = jax_lora.init_lora(jparams, axes, jcfg)
    rng = np.random.default_rng(0)
    # B = 0 at init hides the low-rank fold: give the adapters non-zero B
    jl = {k: {"A": v["A"], "B": jnp.asarray(rng.standard_normal(v["B"].shape, np.float32) * 0.05)}
          for k, v in jl.items()}
    prompt = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, jlora=jl,
                jmerged=jax_lora.merge(jparams, jl, jcfg),
                params=params_from_numpy(jax.device_get(jparams), device="cpu"),
                lora=lora_from_numpy(jax.device_get(jl), device="cpu"), prompt=prompt)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=TOL, atol=TOL)


def test_init_cache_and_params_match_reference_shapes(setup):
    jc = JT.init_cache(setup["jcfg"], B, S + NEW)
    tc = T.init_cache(setup["cfg"], B, S + NEW, device="cpu")
    assert jax.tree.map(lambda a: a.shape, jc) == \
        jax.tree.map(lambda a: tuple(a.shape), tc, is_leaf=lambda t: isinstance(t, torch.Tensor))
    own = T.init_params(setup["cfg"], seed=0, device="cpu")
    shapes = lambda tree, leaf: jax.tree.map(lambda a: tuple(a.shape), tree, is_leaf=leaf)
    assert shapes(own, lambda t: isinstance(t, torch.Tensor)) == shapes(setup["jparams"], None)
    own_lora = torch_lora.init_lora(own, setup["cfg"], device="cpu")
    assert {k: (tuple(v["A"].shape), tuple(v["B"].shape)) for k, v in own_lora.items()} == \
        {k: (v["A"].shape, v["B"].shape) for k, v in setup["jlora"].items()}
    assert all(not v["B"].any() for v in own_lora.values())


def test_merge_matches_reference(setup):
    merged = torch_lora.merge(setup["params"], setup["lora"], setup["cfg"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(setup["jmerged"])[0]:
        node = merged
        for key in path:
            node = node[key.key]
        _close(node, leaf)


def test_forward_and_prefill_logits_match_reference(setup):
    cfg, jcfg, prompt = setup["cfg"], setup["jcfg"], setup["prompt"]
    tokens = torch.from_numpy(prompt).long()
    jbatch = {"tokens": jnp.asarray(prompt), "labels": jnp.asarray(prompt)}
    jlogits, _ = JT.forward(setup["jmerged"], jbatch, jcfg)
    logits = T.forward(setup["params"], {"tokens": tokens}, cfg, lora=setup["lora"])
    _close(logits, jlogits)

    jlogits, jcache = JT.prefill(setup["jmerged"], jbatch, jcfg, JT.init_cache(jcfg, B, S + NEW))
    cache = T.init_cache(cfg, B, S + NEW, device="cpu")
    logits, cache = T.prefill(setup["params"], {"tokens": tokens}, cfg, cache, lora=setup["lora"])
    _close(logits, jlogits)
    for a, b in zip(jax.tree.leaves(jcache), jax.tree.leaves(cache)):
        _close(b, a)


def test_decode_step_logits_match_reference_each_step(setup):
    cfg, jcfg, prompt = setup["cfg"], setup["jcfg"], setup["prompt"]
    jbatch = {"tokens": jnp.asarray(prompt), "labels": jnp.asarray(prompt)}
    jlogits, jcache = JT.prefill(setup["jmerged"], jbatch, jcfg, JT.init_cache(jcfg, B, S + NEW))
    cache = T.init_cache(cfg, B, S + NEW, device="cpu")
    _, cache = T.prefill(setup["params"], {"tokens": torch.from_numpy(prompt).long()}, cfg, cache,
                         lora=setup["lora"])
    tok = jnp.argmax(jlogits[:, -1:, :], axis=-1)
    for pos in range(S, S + NEW - 1):
        jlogits, jcache = JT.decode_step(setup["jmerged"], tok, jcache,
                                         jnp.asarray(pos, jnp.int32), jcfg)
        logits, cache = T.decode_step(setup["params"], torch.from_numpy(np.array(tok)).long(),
                                      cache, pos, cfg, lora=setup["lora"])
        assert logits.shape == (B, 1, cfg.vocab_size)
        _close(logits, jlogits)
        tok = jnp.argmax(jlogits[:, -1, :], axis=-1)[:, None]  # fed the reference's tokens


def test_decode_tokens_greedy_equal_reference(setup):
    prompt = setup["prompt"]
    ref = jax_decode_tokens(setup["jmerged"], setup["jcfg"], jnp.asarray(prompt), NEW)
    out = decode_tokens(setup["params"], setup["cfg"], torch.from_numpy(prompt).long(), NEW,
                        lora=setup["lora"], device="cpu")
    assert out.shape == (B, NEW)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # without adapters the projections are plain x @ W, as the reference serves its base
    base = decode_tokens(setup["params"], setup["cfg"], torch.from_numpy(prompt).long(), NEW,
                         device="cpu")
    ref = jax_decode_tokens(setup["jparams"], setup["jcfg"], jnp.asarray(prompt), NEW)
    np.testing.assert_array_equal(base.numpy(), np.asarray(ref))


def test_decode_tokens_on_cuda_raises_without_gpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        decode_tokens(setup["params"], setup["cfg"], torch.from_numpy(setup["prompt"]).long(), 2)


@pytest.mark.parametrize("builder", ["init_params", "init_cache", "init_lora",
                                     "init_mamba_cache", "tensor_from_numpy",
                                     "params_from_numpy", "lora_from_numpy"])
def test_builders_default_to_the_card(setup, builder):
    """Called without a device, every public builder asks for CUDA: without a
    GPU it raises rather than building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from repro_torch import bridge
    from repro_torch.models import mamba2 as M2

    cfg = setup["cfg"]
    calls = {
        "init_params": lambda: T.init_params(cfg),
        "init_cache": lambda: T.init_cache(cfg, B, S + NEW),
        "init_lora": lambda: torch_lora.init_lora(setup["params"], cfg),
        "init_mamba_cache": lambda: M2.init_mamba_cache(get_arch("mamba2-130m"), B, torch.float32),
        "tensor_from_numpy": lambda: bridge.tensor_from_numpy(np.zeros(3, np.float32)),
        "params_from_numpy": lambda: bridge.params_from_numpy({"w": np.zeros(3, np.float32)}),
        "lora_from_numpy": lambda: bridge.lora_from_numpy(
            {"k": {"A": np.zeros((2, 1), np.float32), "B": np.zeros((1, 2), np.float32)}}),
    }
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        calls[builder]()


def test_unported_config_raises_before_the_device_check():
    """init_params and init_cache check the config first: an unported config
    is a NotImplementedError on any machine, not a device error."""
    bad = smoke_variant(get_arch("fedsllm-100m")).replace(layer_pattern="GL")
    for build in (lambda: T.init_params(bad), lambda: T.init_cache(bad, B, S)):
        with pytest.raises(NotImplementedError):
            build()


def test_unported_configs_raise():
    cfg = smoke_variant(get_arch("fedsllm-100m"))
    for bad in (cfg.replace(layer_pattern="GL"), cfg.replace(family="encdec", layer_pattern="LG"),
                cfg.replace(family="vlm", layer_pattern="RRL")):
        with pytest.raises(NotImplementedError):
            T.init_params(bad)


def _run(code_or_args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, and chip_smoke.py (imported, not run), load
    no jax and no repro.*."""
    res = _run("import importlib, pkgutil, sys, repro_torch\n"
               "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
               "for name in mods: importlib.import_module(name)\n"
               f"sys.path.insert(0, {str(ROOT)!r}); import chip_smoke\n"
               "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
               "print(len(mods), bad)\n")
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert bad == "[]", res.stdout
    # the walk found the package's modules, the kernels' and the models' too
    assert int(n) >= len(list((ROOT / "src" / "repro_torch").rglob("*.py"))) - 1, res.stdout


def test_serve_cli_on_cpu():
    res = _run(["-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--max-new", "4"])
    assert res.returncode == 0, res.stderr
    assert "generated (2, 4)" in res.stdout
    assert "lora_matmul=0 flash_attention=0" in res.stdout  # plain versions on the CPU
