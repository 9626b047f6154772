"""The port's uplink codecs (``api/compressors.py``, ``core/compression.py``),
its DP mechanisms (``core/privacy.py``) and ``remat``, against the reference.

Inputs are drawn with numpy and given to both packages. Tolerances:
  * bit-identical for the ``none``/``int8``/``topk`` codecs (the same
    elementwise arithmetic, ties of ``topk`` included), for the codecs'
    ``bits``/``ratio`` (pure Python) and for ``remat`` against no ``remat``
    (the same graph, recomputed);
  * 1e-5 of the largest value for one split pass with a codec, as for the
    split pass without one (``tests/test_torch_train.py``): the same fp32
    function summed in another order;
  * 1e-6 for DP clipping: one fp32 norm, summed in another order.
``randk`` draws its mask from a ``torch.Generator``, so its coordinates
differ from the reference's ``jax.random.bernoulli``: its keep fraction is
held to the binomial law, and its split pass to the reference's split with
the port's mask.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.compressors import get_compressor as jax_get_compressor
from repro.config import LoRAConfig as JaxLoRAConfig
from repro.config import get_arch as jax_get_arch
from repro.config import smoke_variant as jax_smoke_variant
from repro.core import compression as jax_compression
from repro.core import lora as jax_lora
from repro.core import privacy as jax_privacy
from repro.core import split as jax_split
from repro.models import transformer as JT
from repro.optim.grad_utils import global_norm as jax_global_norm
from repro_torch import bridge
from repro_torch.api.compressors import compressors, get_compressor
from repro_torch.config import LoRAConfig, get_arch, smoke_variant
from repro_torch.core import compression, privacy, split
from repro_torch.tree import tree_leaves, tree_map

CODECS = [("none", {}), ("int8", {}), ("topk", {"fraction": 0.1}), ("topk", {"fraction": 0.37})]


def _ties(rng, shape, dtype=np.float32):
    """Values on a coarse grid, so that many magnitudes tie (the top-k
    threshold among them), with both signs and zeros."""
    return (rng.integers(-12, 13, shape) / 4.0).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the codecs
# ---------------------------------------------------------------------------


def test_registry_names_match_reference():
    from repro.api.compressors import compressors as jax_compressors

    assert compressors.names() == jax_compressors.names() == ["int8", "none", "randk", "topk"]
    with pytest.raises(KeyError, match="known"):
        get_compressor("zstd")


@pytest.mark.parametrize("name,kw", CODECS, ids=[f"{n}{kw}" for n, kw in CODECS])
@pytest.mark.parametrize("shape", [(2, 16, 64), (7, 33), (1,)])
def test_codec_apply_bitwise(name, kw, shape):
    """``apply`` on fp32 inputs with tied magnitudes: bit for bit the
    reference's; the same dtype and shape."""
    x = _ties(np.random.default_rng(sum(shape)), shape)
    want = np.asarray(jax_get_compressor(name, **kw).apply(jnp.asarray(x)))
    got = get_compressor(name, **kw).apply(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_topk_keeps_every_tie_of_the_threshold():
    x = np.array([3.0, -3.0, 1.0, 3.0, 0.5, -2.0], np.float32)
    got = compression.topk_mask(torch.from_numpy(x), 0.3)  # k = 2; 3.0 ties three ways
    np.testing.assert_array_equal(got.numpy(), [1, 1, 0, 1, 0, 0])
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_compression.topk_mask(jnp.asarray(x), 0.3)))


def test_int8_bitwise_in_bfloat16():
    """bfloat16 activations: the absmax scale is taken in the input's dtype,
    as the reference takes it; q, scale and the round trip bit for bit."""
    x = np.random.default_rng(1).standard_normal((4, 40)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jq, js = jax_compression.quantize_int8(jx)
    q, s = compression.quantize_int8(tx)
    assert s.dtype == torch.bfloat16 and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(_np(get_compressor("int8").apply(tx)),
                                  np.asarray(jax_get_compressor("int8").apply(jx), np.float32))


@pytest.mark.parametrize("name,kw", CODECS + [("randk", {"fraction": 0.3, "value_bits": 16})],
                         ids=[f"{n}{kw}" for n, kw in CODECS] + ["randk"])
def test_codec_bits_and_ratio_equal(name, kw):
    codec, jcodec = get_compressor(name, **kw), jax_get_compressor(name, **kw)
    assert codec.ratio == jcodec.ratio
    for n in (1, 2, 1000, 1 << 16, 3 * 5 * 7 * 11 * 13):
        for dense in (16, 32):
            assert codec.bits(n, dense) == jcodec.bits(n, dense), (n, dense)


@pytest.mark.parametrize("fraction", [0.05, 0.5, 0.9])
def test_randk_keep_fraction_and_determinism(fraction):
    """The kept share of n coordinates within 5σ of the binomial law; the
    same mask on every call, for every input of the shape; kept values
    untouched, the rest exactly zero; another seed, another mask."""
    shape = (8, 64, 96)
    n = math.prod(shape)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape).astype(np.float32) + 3)
    codec = get_compressor("randk", fraction=fraction, seed=7)
    y = codec.apply(x)
    kept = y != 0
    sigma = math.sqrt(n * fraction * (1 - fraction))
    assert abs(int(kept.sum()) - n * fraction) <= 5 * sigma
    assert torch.equal(y[kept], x[kept])
    assert torch.equal(get_compressor("randk", fraction=fraction, seed=7).apply(x), y)
    assert torch.equal(codec.apply(2 * x) != 0, kept)
    assert not torch.equal(get_compressor("randk", fraction=fraction, seed=8).apply(x) != 0, kept)


def test_int8_roundtrip_error_small():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32))
    y = get_compressor("int8").apply(x)
    assert float((x - y).abs().max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_compression_tree_helpers_match_reference():
    """Top-k with error feedback (two steps), the int8 tree codec and the
    bit counts of ``core/compression.py``."""
    rng = np.random.default_rng(3)
    tree = {"a": _ties(rng, (6, 10)), "b": [_ties(rng, (17,))]}
    tree2 = {"a": _ties(rng, (6, 10)), "b": [_ties(rng, (17,))]}
    t = lambda tr: tree_map(torch.from_numpy, tr)  # noqa: E731
    j = lambda tr: jax.tree.map(jnp.asarray, tr)  # noqa: E731
    s1, e1, b1 = compression.compress_tree(t(tree), 0.2)
    js1, je1, jb1 = jax_compression.compress_tree(j(tree), 0.2)
    s2, e2, _ = compression.compress_tree(t(tree2), 0.2, error=e1)
    js2, je2, _ = jax_compression.compress_tree(j(tree2), 0.2, error=je1)
    assert b1 == jb1
    for got, want in ((s1, js1), (e1, je1), (s2, js2), (e2, je2)):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    q, bits = compression.compress_tree_int8(t(tree))
    jq, jbits = jax_compression.compress_tree_int8(j(tree))
    assert bits == jbits
    back, jback = compression.decompress_tree_int8(q), jax_compression.decompress_tree_int8(jq)
    for g, w in zip(tree_leaves(back), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert compression.dense_bits(t(tree)) == jax_compression.dense_bits(j(tree))
    assert compression.compressed_bits(t(tree), 0.1, index_bits=5) == \
        jax_compression.compressed_bits(j(tree), 0.1, index_bits=5)


# ---------------------------------------------------------------------------
# one split pass through each codec
# ---------------------------------------------------------------------------


B, S = 2, 16


@pytest.fixture(scope="module")
def split_setup():
    """The smoke fedsllm-100m (fp32), rank 4, non-zero adapters, cut 1."""
    jcfg = jax_smoke_variant(jax_get_arch("fedsllm-100m")).replace(
        lora=JaxLoRAConfig(rank=4, alpha=8.0))
    cfg = smoke_variant(get_arch("fedsllm-100m")).replace(lora=LoRAConfig(rank=4, alpha=8.0))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params, axes = JT.init_params(jcfg, key=jax.random.PRNGKey(0))
    full, _ = jax_lora.init_lora(params, axes, jcfg, key=jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    full = {k: {n: v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
                for n, v in ab.items()} for k, ab in jax.device_get(full).items()}
    lc, ls = jax_lora.split_client_server(full, 1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    return dict(jcfg=jcfg, cfg=cfg, jparams=params, jlc=lc, jls=ls, jbatch=batch,
                params=bridge.params_from_numpy(jax.device_get(params), device="cpu"),
                lc=bridge.lora_from_numpy(jax.device_get(lc), device="cpu"),
                ls=bridge.lora_from_numpy(jax.device_get(ls), device="cpu"),
                batch=bridge.batches_from_numpy(batch, device="cpu"))


@dataclasses.dataclass(frozen=True)
class _MaskOf:
    """The reference side of a ``randk`` pass: the port's mask, as jnp."""

    codec: object

    def apply(self, x):
        mask = self.codec.apply(torch.ones(tuple(x.shape)))
        return x * jnp.asarray(mask.numpy()).astype(x.dtype)

    def bits(self, nelems, dense_bits=32):
        return self.codec.bits(nelems, dense_bits)


def _close_tree(got, want, tol, what):
    for k in want:
        for n in ("A", "B"):
            g, w = _np(got[k][n]), np.asarray(want[k][n], np.float32)
            scale = max(float(np.max(np.abs(w))), 1e-30)
            assert float(np.max(np.abs(g - w))) <= tol * scale, f"{what} {k} {n}"


@pytest.mark.parametrize("name,kw", [("none", {}), ("int8", {}), ("topk", {"fraction": 0.25}),
                                     ("randk", {"fraction": 0.5, "seed": 3})],
                         ids=["none", "int8", "topk", "randk"])
def test_split_pass_with_codec_matches_reference(split_setup, name, kw):
    """Loss, dLoRA_c and dLoRA_s of one split pass with the codec on the
    uplink, within 1e-5; the uplink bits reported equal."""
    s = split_setup
    codec = get_compressor(name, **kw)
    jcodec = _MaskOf(codec) if name == "randk" else jax_get_compressor(name, **kw)
    loss, dc, ds, info = split.split_value_and_grad(s["params"], s["lc"], s["ls"], s["batch"],
                                                    s["cfg"], 1, compressor=codec)
    jloss, jdc, jds, jinfo = jax_split.split_value_and_grad(
        s["jparams"], s["jlc"], s["jls"], s["jbatch"], s["jcfg"], 1, compressor=jcodec)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _close_tree(dc, jax.device_get(jdc), 1e-5, f"{name} dlora_c")
    _close_tree(ds, jax.device_get(jds), 1e-5, f"{name} dlora_s")
    assert info == {k: int(v) if isinstance(v, (int, np.integer)) else v for k, v in jinfo.items()}
    if name == "int8":  # 8 bits per element of the fp32 payload, one fp32 scale
        assert info["smashed_bits_uplink"] == info["smashed_bytes"] * 2 + 32


def test_remat_is_bitwise_the_same(split_setup):
    """``remat=True`` recomputes the groups' activations in the backward
    pass: the same loss and gradients, bit for bit."""
    s = split_setup
    args = (s["params"], s["lc"], s["ls"], s["batch"], s["cfg"], 1)
    plain = split.split_value_and_grad(*args, compressor=get_compressor("int8"))
    remat = split.split_value_and_grad(*args, remat=True, compressor=get_compressor("int8"))
    assert torch.equal(plain[0], remat[0]) and plain[3] == remat[3]
    for a, b in zip(tree_leaves(plain[1:3]), tree_leaves(remat[1:3])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# DP
# ---------------------------------------------------------------------------


def _stacked(rng, K, scales):
    """A stacked (K, ...) adapter-like tree whose clients have norms set by
    ``scales`` (some above the clip, some below)."""
    tree = {"l0": {"A": rng.standard_normal((K, 24, 4)), "B": rng.standard_normal((K, 4, 24))},
            "l1": {"A": rng.standard_normal((K, 24, 4)), "B": rng.standard_normal((K, 4, 24))}}
    return jax.tree.map(lambda x: (x * np.reshape(scales, (K, 1, 1))).astype(np.float32), tree)


def test_global_norm_and_clip_tree_match_reference():
    rng = np.random.default_rng(0)
    for scale in (0.001, 0.05, 3.0):
        tree = jax.tree.map(lambda x: x[0], _stacked(rng, 1, [scale]))
        t = tree_map(torch.from_numpy, tree)
        gn, jgn = privacy.global_norm(t), jax_global_norm(jax.tree.map(jnp.asarray, tree))
        assert abs(float(gn) - float(jgn)) <= 1e-6 * float(jgn)
        got = privacy.clip_tree(t, 1.0)
        want = jax_privacy.clip_tree(jax.tree.map(jnp.asarray, tree), 1.0)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6 * np.abs(w).max())
        assert float(privacy.global_norm(got)) <= 1.0 * (1 + 1e-6)


def test_clip_and_noise_updates_clipping_matches_reference():
    """Per-client clipping of stacked updates (no noise): within 1e-6 of
    the largest value, per leaf; each client's norm at most the clip."""
    rng = np.random.default_rng(1)
    stacked = _stacked(rng, 5, [0.01, 0.2, 1.0, 4.0, 0.0])
    got = privacy.clip_and_noise_updates(tree_map(torch.from_numpy, stacked), None,
                                         clip_norm=0.75, noise_multiplier=0.0)
    want = jax_privacy.clip_and_noise_updates(jax.tree.map(jnp.asarray, stacked),
                                              jax.random.PRNGKey(0), clip_norm=0.75,
                                              noise_multiplier=0.0)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert float(np.max(np.abs(g.numpy() - w))) <= 1e-6 * float(np.max(np.abs(w)))
    for k in range(5):
        norm = float(privacy.global_norm(tree_map(lambda x: x[k], got)))
        assert norm <= 0.75 * (1 + 1e-6)


def test_dp_noise_on_client_zero_slot():
    """With σ = 0.5 and clip 2: the other clients' slots are the clipped
    updates exactly; client 0's slot is its clipped update plus noise whose
    mean is within 5 standard errors of 0 and whose std is within 5% of
    σ·c = 1 (n = 100,000 draws: the std's own standard error is 0.22%);
    the same generator seed gives the same noise, another seed other noise."""
    rng = np.random.default_rng(2)
    K, n = 3, 100_000
    stacked = {"w": torch.from_numpy(rng.standard_normal((K, n)).astype(np.float32))}
    clean = privacy.clip_and_noise_updates(stacked, None, clip_norm=2.0)
    noisy = privacy.clip_and_noise_updates(stacked, torch.Generator().manual_seed(5),
                                           clip_norm=2.0, noise_multiplier=0.5)
    assert torch.equal(noisy["w"][1:], clean["w"][1:])
    noise = (noisy["w"][0] - clean["w"][0]).double()
    assert abs(float(noise.mean())) <= 5 * 1.0 / math.sqrt(n)
    assert abs(float(noise.std()) - 1.0) <= 0.05
    again = privacy.clip_and_noise_updates(stacked, torch.Generator().manual_seed(5),
                                           clip_norm=2.0, noise_multiplier=0.5)
    assert torch.equal(again["w"], noisy["w"])
    other = privacy.clip_and_noise_updates(stacked, torch.Generator().manual_seed(6),
                                           clip_norm=2.0, noise_multiplier=0.5)
    assert not torch.equal(other["w"][0], noisy["w"][0])


def test_noise_layer_snr():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32))
    y = privacy.noise_layer(x, torch.Generator().manual_seed(1), snr_db=20.0)
    snr = float((x ** 2).mean()) / max(float((y - x).var()), 1e-12)
    assert 50 < snr < 200  # 20 dB = 100x
