"""The port's three kernels (K1 MSDA forward, K3 masked flash attention,
K4 greedy NMS): their plain PyTorch twins against the JAX package.

The JAX side runs as its own tests run it on the CPU: the XLA paths, and the
Pallas kernels in interpret mode. On the CPU every wrapper takes its plain
twin, so these tests also hold the wrappers' CPU route. The CUDA kernels
themselves are held against the twins in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from s2d_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from s2d_tpu.ops.ms_deform_attn_pallas import ms_deform_attn_pallas
from s2d_tpu.ops.nms import _greedy_nms_pallas, greedy_mask_nms as jax_greedy_nms

from s2d_tpu_torch import _build
from s2d_tpu_torch.ops import masked_attention_cuda, ms_deform_attn_cuda, nms
from s2d_tpu_torch.ops.masked_attention_cuda import masked_cross_attention
from s2d_tpu_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain

from test_torch_cuda import MSDA_SHAPES, _flash_inputs, _msda_inputs, _nms_case


def test_msda_plain_matches_jax_xla_and_pallas():
    # f32 on both sides: only the summation order differs
    value, locs, weights = _msda_inputs(0)
    got = ms_deform_attn_plain(
        torch.from_numpy(value), MSDA_SHAPES, torch.from_numpy(locs), torch.from_numpy(weights)
    ).numpy()
    ref_xla = np.asarray(jax_msda(
        jnp.asarray(value), MSDA_SHAPES, jnp.asarray(locs), jnp.asarray(weights), impl="xla"
    ))
    ref_pallas = np.asarray(ms_deform_attn_pallas(
        jnp.asarray(value), MSDA_SHAPES, jnp.asarray(locs), jnp.asarray(weights),
        compute_dtype=jnp.float32, q_tile=128, interpret=True,
    ))
    assert got.shape == (2, 20, 4 * 16)
    np.testing.assert_allclose(got, ref_xla, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, ref_pallas, rtol=1e-4, atol=1e-5)


def test_msda_dispatch_cpu_uses_twin_without_launch(monkeypatch):
    monkeypatch.setattr(ms_deform_attn_cuda, "LAUNCHES", 0)
    value, locs, weights = (torch.from_numpy(a) for a in _msda_inputs(1))
    plain = ms_deform_attn(value, MSDA_SHAPES, locs, weights, impl="plain")
    routed = ms_deform_attn(value, MSDA_SHAPES, locs, weights, impl="cuda")
    torch.testing.assert_close(routed, plain, rtol=0, atol=0)
    assert ms_deform_attn_cuda.LAUNCHES == 0
    with pytest.raises(ValueError):
        ms_deform_attn(value, MSDA_SHAPES, locs, weights, impl="pallas")


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Pallas interpret mode for the flash kernel, as tests/test_masked_attention.py."""
    from jax.experimental import pallas as pl
    import s2d_tpu.ops.masked_attention_pallas as map_mod

    orig_call = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig_call(*args, **kwargs)

    monkeypatch.setattr(map_mod.pl, "pallas_call", interp_call)
    return map_mod


@pytest.mark.parametrize("dh", [16, 32])
def test_flash_plain_matches_jax_kernel(interpret_pallas, dh, monkeypatch):
    monkeypatch.setattr(masked_attention_cuda, "LAUNCHES", 0)
    heads = 2
    q, k, v, blocked = _flash_inputs(dh, dh=dh, heads=heads)
    bh, q_len, k_len = q.shape[0], q.shape[1], k.shape[1]
    expanded = torch.from_numpy(blocked).expand(bh // heads, heads, q_len, k_len)
    assert expanded.stride(1) == 0  # the head broadcast is not materialized
    got = masked_cross_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), expanded
    ).numpy()
    ref = np.asarray(interpret_pallas.masked_cross_attention_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(np.broadcast_to(blocked, (bh // heads, heads, q_len, k_len))
                    .reshape(bh, q_len, k_len)),
        k_tile=128,
    ))
    # the tolerance of tests/test_masked_attention.py
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    assert np.all(got[:, 3] == 0.0)  # fully blocked row -> 0, as K3
    assert masked_attention_cuda.LAUNCHES == 0


@settings(max_examples=12, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    n=st.sampled_from([1, 9, 50]),
    grid=st.booleans(),
)
def test_nms_plain_matches_jax_pallas_and_xla(seed, n, grid):
    iou, labels = _nms_case(seed, n, grid)
    got = nms.greedy_mask_nms(torch.from_numpy(iou), torch.from_numpy(labels), 0.75).numpy()
    ref_pl = np.asarray(_greedy_nms_pallas(
        jnp.asarray(iou), jnp.asarray(labels), 0.75, interpret=True
    ))
    ref_xla = np.asarray(jax_greedy_nms(jnp.asarray(iou), jnp.asarray(labels), 0.75))
    np.testing.assert_array_equal(got, ref_pl)
    np.testing.assert_array_equal(got, ref_xla)


def test_nms_cpu_leaves_launch_count(monkeypatch):
    monkeypatch.setattr(nms, "LAUNCHES", 0)
    iou, labels = _nms_case(3, 50, False)
    nms.greedy_mask_nms(torch.from_numpy(iou), torch.from_numpy(labels), 0.75)
    assert nms.LAUNCHES == 0


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as the kernel's cvt.rna.tf32.f32; still stored as f32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul_tf32(a, b):
    """One TF32 tensor-core product: operands rounded, products exact, f32 sums."""
    return _tf32(a) @ _tf32(b)


def _matmul_3xtf32(a, b):
    """K3's split product: x = hi + lo, hi = tf32(x), lo = tf32(x - hi), and
    a . b = lo.hi + hi.lo + hi.hi with f32 sums (lo.lo dropped)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _attention(q, k, v, blocked, matmul):
    """K3's function with both products through `matmul`: (logits, out)."""
    dtype = q.dtype
    logits = matmul(q, k.transpose(0, 2, 1)) * dtype.type(q.shape[-1] ** -0.5)
    logits = np.where(blocked, dtype.type(-1e30), logits)
    m = np.maximum(logits.max(-1, keepdims=True), dtype.type(-1e4))
    p = np.exp(logits - m)
    l = p.sum(-1, keepdims=True)
    return logits, matmul(p, v) / np.where(l > 0, l, dtype.type(1))


def test_flash_3xtf32_split_is_f32_accurate():
    """Why K3 splits its operands: at the decoder's shapes (BH = 8, Q = 100,
    Dh = 32, K = 1920, normal inputs, the mask at 50%), single-pass TF32 puts
    the logits more than the smoke's atol 1e-4 off the float64 result; the
    three-term split keeps the output within 1e-5 of it."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(8, n, 32).astype(np.float32) for n in (100, 1920, 1920))
    blocked = rng.rand(8, 100, 1920) > 0.5
    logits64, out64 = _attention(*(x.astype(np.float64) for x in (q, k, v)), blocked, np.matmul)
    logits1, _ = _attention(q, k, v, blocked, _matmul_tf32)
    logits3, out3 = _attention(q, k, v, blocked, _matmul_3xtf32)
    open_ = ~blocked
    assert np.abs(logits1 - logits64)[open_].max() > 1e-4
    assert np.abs(logits3 - logits64)[open_].max() < 1e-5
    assert np.abs(out3 - out64).max() < 1e-5


def test_tf32_rounding_emulation():
    x = np.array([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-11), 1.0 + 2**-12],
                 np.float32)
    # ties go away from zero; below half an ulp (2^-10) rounds down
    np.testing.assert_array_equal(
        _tf32(x), np.array([1.0, 1.0 + 2**-10, 1.0 + 2**-9, -(1.0 + 2**-10), 1.0], np.float32))


@pytest.mark.parametrize("k_len, keys", [(1920, 128), (7680, 256), (30720, 960), (1, 128)])
def test_flash_key_chunks_cover_the_sms(k_len, keys):
    """K3's chunk of keys a block at the decoder's shapes on 132 SMs: whole
    64-key tiles, at least 2, and at most 2 blocks an SM, at least 1 where K
    allows it."""
    assert masked_attention_cuda.chunk_keys(8, 100, k_len, 132) == keys
    blocks = 8 * -(-k_len // keys)
    assert blocks <= 2 * 132 and (keys == 128 or blocks >= 132)


@pytest.mark.parametrize("bh, q_len, k_len, keys", [(8, 130, 30720, 1920), (1, 17, 1921, 128)])
def test_flash_key_chunks_other_rows(bh, q_len, k_len, keys):
    """K3's chunk where the rows take two query blocks (Q = 130) or one head
    holds few tiles: the grid stays within 2 blocks an SM of 132, and above
    1 an SM where K allows it."""
    assert masked_attention_cuda.chunk_keys(bh, q_len, k_len, 132) == keys
    blocks = bh * -(-q_len // masked_attention_cuda.QUERY_ROWS) * -(-k_len // keys)
    assert blocks <= 2 * 132 and (keys == 128 or blocks >= 132)
