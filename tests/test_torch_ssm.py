"""The port's SSM slice (mamba2) against the reference.

The SSD plain versions (the port's ``ssd_scan`` wrapper on the CPU, its
sequential ``ssd_scan_ref``, the model's ``ssd_chunked``) against the
reference's Pallas kernel (interpret mode, as ``test_kernels.py`` runs it),
its sequential oracle and its ``ssd_chunked`` with initial and final states;
then the mamba2 block and the served model on ``smoke_variant(mamba2-130m)``
in fp32 (2 layers, d_model 64, 8 SSD heads of 16, state 16, chunk 16), with
reference parameters and non-zero adapters bridged through
``repro_torch.bridge``. The CUDA kernel itself is held against its plain
version on the card by ``test_torch_cuda.py``.

Tolerances: 1e-5 where both sides do the same fp32 sums in the same order
(the conv, the one-step update); 1e-4 of the largest output where the SSD is
summed in another order (exp of cumulative sums for products of per-step
decays, chunked against sequential); 1e-4 for logits, as in
``test_torch_serving.py``.
"""

import dataclasses
import hashlib
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
from repro.kernels.ssd_ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.models import mamba2 as JM2
from repro.models import transformer as JT
from repro.serving.decode import decode_tokens as jax_decode_tokens
from repro_torch.bridge import lora_from_numpy, params_from_numpy
from repro_torch.config import LoRAConfig, get_arch, smoke_variant
from repro_torch.kernels import ssd_ref
from repro_torch.kernels import ssd_scan as ssd_binding
from repro_torch.kernels.ssd_ops import ssd_scan
from repro_torch.kernels.ssd_ref import ssd_scan_ref, ssd_scan_split_ref, ssd_scan_tf32x3_ref
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as T
from repro_torch.serving.decode import decode_tokens

B, S, NEW = 2, 24, 4
SAME_SUMS = 1e-5  # both sides do the same fp32 sums in the same order
SSD_REL = 1e-4  # of the largest output: the SSD summed in another order
LOGITS = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_rel(got, want, rel=SSD_REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, rtol=rel, atol=rel)


def _ssd_inputs(b, s, h, p, n, seed=0):
    """The distributions of test_kernels.py's SSD cases, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


# ---------------------------------------------------------------------------
# SSD scan: plain versions against the Pallas kernel and the oracles
# ---------------------------------------------------------------------------

# test_kernels.py's SSD_CASES: (B, S, H, P, N, chunk)
SSD_CASES = [
    (2, 64, 3, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (1, 64, 1, 8, 8, 64),  # single chunk
    (2, 96, 2, 16, 8, 32),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_plain_matches_pallas_and_ref(b, s, h, p, n, chunk):
    x, dt, A, Bm, Cm, _ = _ssd_inputs(b, s, h, p, n)
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    targs = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    y, h_final = ssd_scan(*targs)  # the wrapper: on the CPU, the plain version
    assert y.dtype == h_final.dtype == torch.float32 and y.shape == (b, s, h, p)
    y_ref, h_ref = ssd_scan_ref(*targs)
    y_chunked, h_chunked = M2.ssd_chunked(*targs, chunk)
    pallas = jax_ssd_scan(*jargs, chunk=chunk)
    oracle = jax_ssd_scan_ref(*jargs)
    for got in (y, y_ref, y_chunked):
        _close_rel(got, pallas)
        _close_rel(got, oracle)
    _, jh = JM2.ssd_chunked(*jargs, chunk)
    for got in (h_final, h_ref, h_chunked):
        _close_rel(got, jh)


@pytest.mark.parametrize("s,chunk", [(40, 16), (16, 16), (7, 16), (1, 4)])
def test_ssd_initial_and_final_state_match_reference_chunked(s, chunk):
    """From a non-zero initial state, ragged S included: y and the final
    state of the port's plain versions against the reference's ssd_chunked."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(2, s, 3, 8, 8, seed=s)
    jy, jh = JM2.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
                             initial_state=jnp.asarray(h0))
    targs = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    th0 = torch.from_numpy(h0)
    for y, h in (ssd_scan(*targs, initial_state=th0), ssd_scan_ref(*targs, th0),
                 M2.ssd_chunked(*targs, chunk, th0)):
        _close_rel(y, jy)
        _close_rel(h, jh)
    assert torch.equal(th0, torch.from_numpy(h0))  # the initial state is not written


def _bf16_exact(a):
    """a rounded to bf16 and back: values the wgmma variant reads exactly."""
    return torch.from_numpy(a).bfloat16().float().numpy()


# (B, S, H, P, N, the Pallas kernel's chunk, initial state)
SPLIT_CASES = [(*case, False) for case in SSD_CASES] + [
    (2, 200, 3, 32, 64, 64, True),  # ragged S from an initial state
    (1, 512, 2, 64, 128, 256, False),  # mamba2-130m widths
    # states wider than 256, split across blocks (two slices of 192 and of
    # 256 columns), a ragged S (not a multiple of the kernel's 64 steps)
    (1, 200, 2, 32, 320, 50, False),
    (1, 200, 2, 32, 320, 50, True),
    (1, 130, 2, 16, 512, 65, False),
    (1, 130, 2, 16, 512, 65, True),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_state", SPLIT_CASES)
def test_ssd_split_ref_matches_pallas_and_ref(b, s, h, p, n, chunk, with_state):
    """The wgmma variant's arithmetic (chunks of 64, two-term bf16 splits of
    G, h and w⊙x) within 1e-4 of the largest output of the reference's
    Pallas kernel (interpret mode) and sequential oracle, or, from an
    initial state, of its ssd_chunked; x, B and C bf16-rounded, as the
    variant reads them."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(b, s, h, p, n, seed=s + p)
    x, Bm, Cm = _bf16_exact(x), _bf16_exact(Bm), _bf16_exact(Cm)
    h0 = h0 if with_state else None
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    y, h_final = ssd_scan_split_ref(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                                    None if h0 is None else torch.from_numpy(h0))
    assert y.dtype == h_final.dtype == torch.float32
    assert y.shape == (b, s, h, p) and h_final.shape == (b, h, p, n)
    jy, jh = JM2.ssd_chunked(*jargs, chunk, initial_state=None if h0 is None else jnp.asarray(h0))
    if h0 is None:
        _close_rel(y, jax_ssd_scan(*jargs, chunk=chunk))
        _close_rel(y, jax_ssd_scan_ref(*jargs))
    _close_rel(y, jy)
    _close_rel(h_final, jh)


@pytest.mark.parametrize("dropped", [None, "G", "h", "xw"])
def test_ssd_split_needs_two_terms_of_each_operand(dropped):
    """The precision argument of the wgmma variant, at mamba2-130m widths with
    the prefill's distributions: with hi + lo terms of G, h and w⊙x the
    chunked arithmetic is within 1e-4 of the largest output of the sequential
    recurrence; without the lo term of any one of them it is not."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 1, 512, 2, 64, 128
    x = _bf16_exact(0.5 * rng.standard_normal((b, s, h, p), np.float32))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2)).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    Bm, Cm = (_bf16_exact(0.5 * rng.standard_normal((b, s, n), np.float32)) for _ in range(2))
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, h0)]
    y_ref, h_ref = ssd_scan_ref(*args)
    kept = tuple(o for o in ssd_ref.SPLIT_OPERANDS if o != dropped)
    y, h_final = ssd_scan_split_ref(*args, lo_terms=kept)
    err = max(float((y - y_ref).abs().max() / y_ref.abs().max()),
              float((h_final - h_ref).abs().max() / h_ref.abs().max()))
    assert (err <= SSD_REL) == (dropped is None), err


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_state", SPLIT_CASES)
def test_ssd_tf32x3_ref_matches_pallas_and_ref(b, s, h, p, n, chunk, with_state):
    """The tf32 variant's arithmetic (chunks of 64, every product in 3xTF32:
    TF32 big and small terms of C, B, h, G, x and w⊙x, the chunk's state
    update summed from zero) within 1e-4 of the largest output of the
    reference's Pallas kernel (interpret mode) and sequential oracle, or,
    from an initial state, of its ssd_chunked; fp32 inputs."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(b, s, h, p, n, seed=s + p + 1)
    h0 = h0 if with_state else None
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    y, h_final = ssd_scan_tf32x3_ref(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                                     None if h0 is None else torch.from_numpy(h0))
    assert y.dtype == h_final.dtype == torch.float32
    assert y.shape == (b, s, h, p) and h_final.shape == (b, h, p, n)
    jy, jh = JM2.ssd_chunked(*jargs, chunk, initial_state=None if h0 is None else jnp.asarray(h0))
    if h0 is None:
        _close_rel(y, jax_ssd_scan(*jargs, chunk=chunk))
        _close_rel(y, jax_ssd_scan_ref(*jargs))
    _close_rel(y, jy)
    _close_rel(h_final, jh)


@pytest.mark.parametrize("dropped", [None, *ssd_ref.TF32_OPERANDS])
def test_ssd_tf32x3_needs_each_small_term(dropped):
    """The precision argument of the tf32 variant, at mamba2-130m widths with
    the prefill's distributions in fp32: with the small terms of C, B, h, G,
    x and w⊙x the three products a pair are within 1e-4 of the largest
    output of the sequential recurrence (y and the final state); without any
    one of them (its product, small·big, left out) they are not."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 1, 512, 2, 64, 128
    x = (0.5 * rng.standard_normal((b, s, h, p))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2)).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    Bm, Cm = ((0.5 * rng.standard_normal((b, s, n))).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, h0)]
    y_ref, h_ref = ssd_scan_ref(*args)
    kept = tuple(o for o in ssd_ref.TF32_OPERANDS if o != dropped)
    y, h_final = ssd_scan_tf32x3_ref(*args, terms=kept)
    err = max(float((y - y_ref).abs().max() / y_ref.abs().max()),
              float((h_final - h_ref).abs().max() / h_ref.abs().max()))
    assert (err <= SSD_REL) == (dropped is None), err


@pytest.mark.parametrize("dtype,P,N,expected", [
    (torch.bfloat16, 64, 128, "wgmma"),  # the mamba2-130m prefill
    (torch.float32, 64, 128, "tf32"),
    (torch.bfloat16, 24, 40, "wgmma"),
    (torch.float32, 24, 40, "tf32"),
    (torch.bfloat16, 64, 320, "wgmma"),  # N over 256: split across blocks
    (torch.float32, 64, 320, "tf32"),
])
def test_ssd_variant_rule(dtype, P, N, expected):
    """The rule that routes a CUDA launch, decided before it from the dtype
    alone, at every P and N (the card tests run every variant); the wgmma
    variant takes every stride and alignment, copying the tiles of the
    operands a tensor map cannot read
    (``test_torch_cuda.py::test_ssd_copied_follows_the_tma_rule``)."""
    assert ssd_binding.variant(dtype) == expected


@pytest.mark.parametrize("N,slices,width", [
    (1, 1, 64), (16, 1, 64), (128, 1, 128), (200, 1, 256), (256, 1, 256),
    (257, 2, 192), (320, 2, 192), (384, 2, 192), (385, 2, 256), (512, 2, 256),
    (513, 3, 192), (1024, 4, 256), (1025, 5, 256),
])
def test_ssd_n_slices(N, slices, width):
    """The split of N across blocks: ceil(N / 256) slices of equal width, a
    multiple of 64 (the kernel's column blocks) no wider than 256; one slice
    up to 256."""
    assert ssd_binding.n_slices(N) == slices and ssd_binding.slice_width(N) == width


def test_ssd_slices_cover_n_once():
    """Every N to 4096: the slices hold every column, and none of them is
    wholly past N (the last holds at least one real column)."""
    for N in range(1, 4097):
        ns, w = ssd_binding.n_slices(N), ssd_binding.slice_width(N)
        assert w % 64 == 0 and w <= 256 and (ns - 1) * w < N <= ns * w, (N, ns, w)


# sha256 (first 16 hex digits) of y's then the final state's fp32 bytes
# that the mirrors returned before N was split across blocks (the whole of
# N in one pass), at test_ssd_mirrors_split_only_above_256's inputs
UNSPLIT_BITS = {
    ("ssd_scan_split_ref", 40): "39882f694b603b57",
    ("ssd_scan_split_ref", 128): "fae5a7b30fefdee3",
    ("ssd_scan_split_ref", 256): "e2f3098589ee37f9",
    ("ssd_scan_tf32x3_ref", 40): "2d3ec46138bd8552",
    ("ssd_scan_tf32x3_ref", 128): "16bd123a83eaa8ed",
    ("ssd_scan_tf32x3_ref", 256): "9de3377062c6d35a",
}


@pytest.mark.parametrize("mirror", [ssd_scan_split_ref, ssd_scan_tf32x3_ref])
@pytest.mark.parametrize("N", [40, 128, 256, 320, 512])
def test_ssd_mirrors_split_only_above_256(mirror, N):
    """Up to N = 256 the mirrors take one slice: the same bits as before N
    was split (``UNSPLIT_BITS``). Above, a partial y per slice added in
    slice order: other bits than one slice of N (``width=N``), within 1e-4
    of its largest output."""
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in _ssd_inputs(1, 100, 2, 16, N, seed=N))
    y, h = mirror(x, dt, A, Bm, Cm, h0)
    if N <= 256:
        bits = hashlib.sha256(y.contiguous().numpy().tobytes()
                              + h.contiguous().numpy().tobytes()).hexdigest()[:16]
        assert bits == UNSPLIT_BITS[mirror.__name__, N]
    else:
        y1, h1 = mirror(x, dt, A, Bm, Cm, h0, width=N)
        assert not torch.equal(y, y1)
        _close_rel(y, y1)
        _close_rel(h, h1)


def test_ssd_smem_bytes_mirror_the_kernel_layouts():
    """smem_bytes mirrors csrc/ssd_scan.cu: tc::Layout<2, COPY>::SMEM at the
    main path (1 KiB alignment + x, B, C of a chunk + h's and w⊙x's terms +
    the chunk's cs, dt + the barrier: three blocks per SM; + the copied
    boxes' staging: two), tf32::Layout::SMEM (the raw blocks + the terms + cs,
    dt: two), each at a block's slice of N (``slice_width``): states wider
    than 256 take the layouts of their slices."""
    assert ssd_binding.smem_bytes("wgmma", 64, 128) == 1024 + 36864 + 16384 + 8192 + 512 + 8
    assert 3 * (ssd_binding.smem_bytes("wgmma", 64, 128) + 1024) <= 228 * 1024
    copied = ssd_binding.smem_bytes("wgmma", 64, 128, copied=True)
    assert copied == ssd_binding.smem_bytes("wgmma", 64, 128) + 5120 + 4 * 9216
    assert 2 * (copied + 1024) <= 228 * 1024
    assert ssd_binding.smem_bytes("wgmma", 24, 40) == ssd_binding.smem_bytes("wgmma", 64, 64)
    assert ssd_binding.smem_bytes("tf32", 64, 128) == 1024 + 40960 + 32768 + 32768 + 512
    assert ssd_binding.smem_bytes("tf32", 16, 16) == ssd_binding.smem_bytes("tf32", 64, 256)
    assert 2 * (ssd_binding.smem_bytes("tf32", 64, 128) + 1024) <= 228 * 1024
    assert ssd_binding.smem_bytes("tf32", 64, 1024) == ssd_binding.smem_bytes("tf32", 64, 128)
    for N, slice_n in ((320, 192), (512, 256), (1024, 256), (1025, 256), (513, 192)):
        for copied in (False, True):
            smem = ssd_binding.smem_bytes("wgmma", 64, N, copied)
            assert smem == ssd_binding.smem_bytes("wgmma", 64, slice_n, copied)
            assert (1 if copied else 2) * (smem + 1024) <= 228 * 1024  # blocks an SM


def test_ssd_wrapper_rejects_bad_inputs():
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in _ssd_inputs(1, 8, 2, 4, 4))
    with pytest.raises(ValueError):
        ssd_scan(x, dt[:, :4], A, Bm, Cm)  # S differs
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A[:1], Bm, Cm)  # one A for two heads
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm, Cm[..., :2])  # Bm, Cm widths differ
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm, Cm, initial_state=h0[..., :2])
    with pytest.raises(TypeError):
        ssd_scan(x, dt, A, Bm.double(), Cm)


# ---------------------------------------------------------------------------
# The mamba2 block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_variant(jax_get_arch("mamba2-130m"))
    cfg = smoke_variant(get_arch("mamba2-130m"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)  # configs copied verbatim
    assert dataclasses.asdict(get_arch("mamba2-130m")) == \
        dataclasses.asdict(jax_get_arch("mamba2-130m"))
    jparams, axes = JT.init_params(jcfg, key=jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    # the reference's init gives every head A = -1, dt_bias = 0, D = 1 and
    # conv_b = 0, which would hide a head-indexing fault: draw them per head
    m = dict(jparams["groups"]["sub_0"]["mamba"])
    L, H = m["A_log"].shape
    m["A_log"] = jnp.asarray(rng.uniform(-1.0, 1.5, (L, H)), jnp.float32)
    m["dt_bias"] = jnp.asarray(rng.uniform(-3.0, 0.5, (L, H)), jnp.float32)
    m["D_skip"] = jnp.asarray(1 + 0.5 * rng.standard_normal((L, H)), jnp.float32)
    m["conv_b"] = jnp.asarray(0.1 * rng.standard_normal(m["conv_b"].shape), jnp.float32)
    jparams = {**jparams, "groups": {"sub_0": {**jparams["groups"]["sub_0"], "mamba": m}}}
    jl, _ = jax_lora.init_lora(jparams, axes, jcfg)
    assert sorted(k.split("'")[-2] for k in jl) == ["in_proj", "out_proj"]
    # B = 0 at init hides the low-rank fold: give the adapters non-zero B
    jl = {k: {"A": v["A"], "B": jnp.asarray(rng.standard_normal(v["B"].shape, np.float32) * 0.05)}
          for k, v in jl.items()}
    prompt = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, jlora=jl,
                jmerged=jax_lora.merge(jparams, jl, jcfg),
                params=params_from_numpy(jax.device_get(jparams), device="cpu"),
                lora=lora_from_numpy(jax.device_get(jl), device="cpu"), prompt=prompt)


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def test_init_cache_and_params_match_reference_shapes(setup):
    jc = JT.init_cache(setup["jcfg"], B, S + NEW)
    tc = T.init_cache(setup["cfg"], B, S + NEW, device="cpu")
    leaf = lambda t: isinstance(t, torch.Tensor)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jc) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tc, is_leaf=leaf)
    own = T.init_params(setup["cfg"], seed=0, device="cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), own,
                        is_leaf=leaf) == \
        jax.tree.map(lambda a: (a.shape, str(a.dtype)), setup["jparams"])


@pytest.mark.parametrize("s", [1, 2, 3, 24])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(setup, s, with_state):
    p = _layer(setup["jparams"]["groups"]["sub_0"]["mamba"])
    W, ch = p["conv_w"].shape
    rng = np.random.default_rng(s)
    xbc = rng.standard_normal((B, s, ch), np.float32)
    state = rng.standard_normal((B, W - 1, ch), np.float32) if with_state else None
    jout, jstate = JM2._causal_conv(jnp.asarray(xbc), p["conv_w"], p["conv_b"],
                                    None if state is None else jnp.asarray(state))
    out, new_state = M2._causal_conv(torch.from_numpy(xbc), torch.from_numpy(np.array(p["conv_w"])),
                                     torch.from_numpy(np.array(p["conv_b"])),
                                     None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(_np(out), _np(jout), rtol=SAME_SUMS, atol=SAME_SUMS)
    np.testing.assert_array_equal(_np(new_state), _np(jstate))  # a copy of the last W-1 rows
    assert new_state.shape == (B, W - 1, ch)


def test_ssd_decode_step_matches_reference():
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(2, 1, 3, 8, 8, seed=4)
    jy, jh = JM2.ssd_decode_step(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, h0)))
    y, h = M2.ssd_decode_step(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, h0)))
    np.testing.assert_allclose(_np(y), _np(jy), rtol=SAME_SUMS, atol=SAME_SUMS)
    np.testing.assert_allclose(_np(h), _np(jh), rtol=SAME_SUMS, atol=SAME_SUMS)


@pytest.mark.parametrize("s,kernels", [(24, True), (24, False), (1, True)])
def test_apply_mamba_matches_reference(setup, s, kernels):
    """One block, from a non-zero cache (prefill for s > 1, decode for s = 1,
    which takes no prefill switch) and without one; the port's adapters
    unmerged against the reference's merged weights."""
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    jp = _layer(setup["jmerged"]["groups"]["sub_0"]["mamba"])
    p = _layer(setup["params"]["groups"]["sub_0"]["mamba"])
    scale = (cfg.lora or LoRAConfig()).scale
    ab = {name: setup["lora"][f"['groups']['sub_0']['mamba']['{name}']"]
          for name in ("in_proj", "out_proj")}
    ad = {name: (v["A"][0], v["B"][0], scale) for name, v in ab.items()}
    rng = np.random.default_rng(7)
    u = rng.standard_normal((B, s, cfg.d_model), np.float32)
    conv, ssd = JM2.init_mamba_cache(jcfg, B, jnp.float32)
    conv = rng.standard_normal(conv.shape, np.float32)
    ssd = rng.standard_normal(ssd.shape, np.float32)
    jout, jcache = JM2.apply_mamba(jp, jnp.asarray(u), jcfg, (jnp.asarray(conv), jnp.asarray(ssd)))
    cache = (torch.from_numpy(conv.copy()), torch.from_numpy(ssd.copy()))
    out = M2.apply_mamba(p, torch.from_numpy(u), cfg, cache, adapters=ad, kernels=kernels)
    _close_rel(out, jout)
    _close_rel(cache[0], jcache[0])
    _close_rel(cache[1], jcache[1])
    if s > 1:  # no cache: prefill from a zero state
        jout, _ = JM2.apply_mamba(jp, jnp.asarray(u), jcfg)
        _close_rel(M2.apply_mamba(p, torch.from_numpy(u), cfg, adapters=ad, kernels=kernels), jout)


# ---------------------------------------------------------------------------
# The served model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernels", [True, False])
def test_prefill_and_decode_steps_match_reference(setup, kernels):
    """T.prefill + three T.decode_steps against JT.prefill/JT.decode_step,
    logits and caches, fed the reference's greedy tokens."""
    cfg, jcfg, prompt = setup["cfg"], setup["jcfg"], setup["prompt"]
    jbatch = {"tokens": jnp.asarray(prompt), "labels": jnp.asarray(prompt)}
    jlogits, jcache = JT.prefill(setup["jmerged"], jbatch, jcfg, JT.init_cache(jcfg, B, S + NEW))
    cache = T.init_cache(cfg, B, S + NEW, device="cpu")
    logits, cache = T.prefill(setup["params"], {"tokens": torch.from_numpy(prompt).long()}, cfg,
                              cache, lora=setup["lora"], kernels=kernels)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=LOGITS, atol=LOGITS)
    for a, b in zip(jax.tree.leaves(jcache), jax.tree.leaves(cache)):
        _close_rel(b, a)
    tok = jnp.argmax(jlogits[:, -1:, :], axis=-1)
    for pos in range(S, S + 3):
        jlogits, jcache = JT.decode_step(setup["jmerged"], tok, jcache,
                                         jnp.asarray(pos, jnp.int32), jcfg)
        logits, cache = T.decode_step(setup["params"], torch.from_numpy(np.array(tok)).long(),
                                      cache, pos, cfg, lora=setup["lora"])
        assert logits.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=LOGITS, atol=LOGITS)
        tok = jnp.argmax(jlogits[:, -1, :], axis=-1)[:, None]
    for a, b in zip(jax.tree.leaves(jcache), jax.tree.leaves(cache)):
        _close_rel(b, a)


def test_decode_tokens_greedy_equal_reference(setup):
    prompt = setup["prompt"]
    ref = jax_decode_tokens(setup["jmerged"], setup["jcfg"], jnp.asarray(prompt), NEW)
    out = decode_tokens(setup["params"], setup["cfg"], torch.from_numpy(prompt).long(), NEW,
                        lora=setup["lora"], device="cpu")
    assert out.shape == (B, NEW)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_decode_tokens_on_cuda_raises_without_gpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):  # the default device, no fallback
        decode_tokens(setup["params"], setup["cfg"], torch.from_numpy(setup["prompt"]).long(), 2)


def test_serve_cli_on_cpu_mamba2():
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mamba2-130m",
                          "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "24",
                          "--max-new", "4"], cwd=root, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert res.returncode == 0, res.stderr
    assert "arch=mamba2-130m-smoke device=cpu generated (2, 4)" in res.stdout
    # the plain versions on the CPU: no kernel launched
    assert "lora_matmul=0 flash_attention=0 ssd_scan=0" in res.stdout


def test_other_families_still_raise():
    cfg = smoke_variant(get_arch("mamba2-130m"))
    for bad in (cfg.replace(layer_pattern="MG"), cfg.replace(family="hybrid"),
                cfg.replace(family="encdec", layer_pattern="M")):
        with pytest.raises(NotImplementedError):
            T.init_params(bad)
