"""The MSDA separable-sampling ablation (K6): the port's plain version
against the JAX tool's Pallas kernel (`tools/bench_pallas_ablate.py:make`)
in interpret mode, the wrapper's CPU route, and the port's ablation tool.

The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import argparse
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from s2d_tpu_torch.ops import msda_ablate_cuda
from s2d_tpu_torch.ops.msda_ablate import VARIANTS, msda_ablate_plain
from s2d_tpu_torch.tools import bench_pallas_ablate

from test_torch_cuda import ABLATE, _ablate_inputs, _ablate_tensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NG, K, W, D, P_TILE, GQP = (ABLATE[k] for k in ("ng", "k", "w", "d", "p_tile", "gqp"))


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX tool, loaded from its file with the CPU platform set first
    (its import sets the runtime up), its pallas_call in interpret mode as
    tests/test_torch_kernels.py runs the flash kernel."""
    old = os.environ.get("S2D_PLATFORM")
    os.environ["S2D_PLATFORM"] = "cpu"
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_bench_pallas_ablate", os.path.join(REPO, "tools", "bench_pallas_ablate.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if old is None:
            os.environ.pop("S2D_PLATFORM")
        else:
            os.environ["S2D_PLATFORM"] = old
    orig_call = mod.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig_call(*args, **kwargs)

    mod.pl.pallas_call = interp_call
    try:
        yield mod
    finally:
        mod.pl.pallas_call = orig_call


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_pallas_interpret(jax_tool, variant):
    vt, ya, x0, (wy0, wy1, wx0, wx1) = _ablate_inputs(0)
    fn = jax_tool.make(variant, NG, W * D, K, GQP, W, D, P_TILE)
    ref = np.asarray(fn(jnp.asarray(vt, jnp.bfloat16), jnp.asarray(ya), jnp.asarray(wy0),
                        jnp.asarray(wy1), jnp.asarray(x0), jnp.asarray(wx0), jnp.asarray(wx1)))
    args = _ablate_tensors(vt, ya, x0, [wy0, wy1, wx0, wx1])
    got = msda_ablate_plain(variant, *args, W, D).numpy()
    assert got.shape == ref.shape == (NG, D, GQP)
    if variant in ("empty", "noconstruct"):
        np.testing.assert_array_equal(got, ref)
    else:
        # f32 products of bf16 values are exact; the two frameworks may
        # round the sums of the two corners in another order
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    if variant == "full":  # the dropped corners carry weight
        assert np.abs(got[:, :, 8:32]).max() > 0


def test_wrapper_takes_plain_version_on_cpu(monkeypatch):
    monkeypatch.setattr(msda_ablate_cuda, "LAUNCHES", dict.fromkeys(VARIANTS, 0))
    args = _ablate_tensors(*_ablate_inputs(1))
    for variant in VARIANTS:
        got = msda_ablate_cuda.msda_ablate(variant, *args, W, D)
        torch.testing.assert_close(got, msda_ablate_plain(variant, *args, W, D), rtol=0, atol=0)
    assert msda_ablate_cuda.LAUNCHES == dict.fromkeys(VARIANTS, 0)
    with pytest.raises(ValueError, match="variant"):
        msda_ablate_cuda.msda_ablate("fused", *args, W, D)
    with pytest.raises(ValueError, match="rows"):
        msda_ablate_plain("full", *args, W + 1, D)


def test_ablation_tool_on_cpu(capsys):
    report = bench_pallas_ablate.run(argparse.Namespace(
        h=2, w=5, g=2, p_tile=128, n=4, d=8, qp=100, k=16, seed=0, iters=1, device="cpu"))
    assert list(report) == list(VARIANTS)
    for variant, r in report.items():
        assert r["max_abs_err"] == 0.0  # on the CPU the wrapper is the plain version
        assert r["bound_ms"] > 0 and r["bound_by"] == "bytes"
    out = capsys.readouterr().out
    assert "points (2, 1, 256)" in out  # g*qp = 200 padded to a multiple of 128
    for variant in VARIANTS:
        assert f"{variant}: " in out


def test_ablation_bytes_at_the_tool_defaults():
    """The bound's bytes at the defaults, from shapes alone (meta tensors):
    the output 158.9 MB, vt 1.3 MB, the six point arrays 29.8 MB."""
    args = bench_pallas_ablate.parse_args([])
    ng, gqp = args.n // args.g, 155136
    inputs = {"vt": torch.empty(ng, args.w * args.d, args.k, dtype=torch.bfloat16, device="meta"),
              "ya": torch.empty(ng, 1, gqp, dtype=torch.int32, device="meta")}
    full, _ = bench_pallas_ablate.work("full", inputs, args.d)
    empty, _ = bench_pallas_ablate.work("empty", inputs, args.d)
    assert empty == 158_859_264
    assert full == 158_859_264 + 1_310_720 + 29_786_112
