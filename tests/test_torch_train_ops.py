"""The train slice's kernels and small pieces against the JAX package, on the
CPU: K2's plain version (autograd through the plain MSDA) against `jax.grad`
of the XLA MSDA and the Pallas backward in interpret mode; the plain auction
(K5's plain version) bit-identical to the XLA auction and the Pallas kernel
in interpret mode; point sampling; the config loader; schedules and
parameter labels. On the CPU every wrapper takes its plain version, so no
kernel launches here."""
import dataclasses
import glob
import os
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

import s2d_tpu.ops.auction as jax_auction
from s2d_tpu.config import load_config as jax_load_config
from s2d_tpu.ops.auction_pallas import auction_asym_pallas
from s2d_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from s2d_tpu.ops.ms_deform_attn_pallas import ms_deform_attn_pallas
from s2d_tpu.ops.sampling import grid_sample_rows as jax_grid_sample_rows
from s2d_tpu.train import label_params as jax_label_params
from s2d_tpu.train.schedules import (
    ema_momentum_schedule as jax_ema,
    loss_weight_factors as jax_factors,
    warmup_multistep_lr as jax_lr,
)

from s2d_tpu_torch.config import load_config_tree
from s2d_tpu_torch.ops import auction, auction_cuda, ms_deform_attn_cuda
from s2d_tpu_torch.ops.sampling import grid_sample_rows
from s2d_tpu_torch.train import schedules
from s2d_tpu_torch.train.optim import label_params

from test_torch_cuda import MSDA_SHAPES, _msda_inputs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_msda_backward_plain_matches_jax_grad_and_pallas(monkeypatch):
    """d value, d locations, d weights at rtol 1e-4 / atol 1e-5 (summation
    order): a tall level (10 x 3), points outside [0, 1] and far outside,
    and 20 queries in a 128-query tile (padding)."""
    monkeypatch.setattr(ms_deform_attn_cuda, "BWD_LAUNCHES", 0)
    value, locs, weights = _msda_inputs(2)
    g = np.random.RandomState(3).randn(value.shape[0], locs.shape[1],
                                       value.shape[2] * value.shape[3]).astype(np.float32)
    got = ms_deform_attn_cuda.ms_deform_attn_bwd_cuda(
        *(torch.from_numpy(a) for a in (value,)), MSDA_SHAPES,
        torch.from_numpy(locs), torch.from_numpy(weights), torch.from_numpy(g))
    args = (jnp.asarray(value), jnp.asarray(locs), jnp.asarray(weights))
    refs = {
        "xla": jax.vjp(lambda v, l, w: jax_msda(v, MSDA_SHAPES, l, w, impl="xla"), *args)[1],
        "pallas": jax.vjp(lambda v, l, w: ms_deform_attn_pallas(
            v, MSDA_SHAPES, l, w, compute_dtype=jnp.float32, q_tile=128, interpret=True),
            *args)[1],
    }
    for name, vjp in refs.items():
        for got_i, ref_i, what in zip(got, vjp(jnp.asarray(g)), ("value", "loc", "weights")):
            np.testing.assert_allclose(got_i.numpy(), np.asarray(ref_i), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} d {what}")
    # the autograd route of the wrapper on the CPU: the same gradients
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (value, locs, weights)]
    ms_deform_attn_cuda.ms_deform_attn_cuda(leaves[0], MSDA_SHAPES, leaves[1], leaves[2]).backward(
        torch.from_numpy(g))
    for leaf, ref in zip(leaves, got):
        torch.testing.assert_close(leaf.grad, ref, rtol=0, atol=0)
    assert ms_deform_attn_cuda.BWD_LAUNCHES == 0


def _jax_assign(cost, valid, exact):
    prev, jax_auction.IMPL = jax_auction.IMPL, "xla"
    try:
        return np.asarray(jax_auction.auction_assign(
            jnp.asarray(cost), None if valid is None else jnp.asarray(valid), exact=exact))
    finally:
        jax_auction.IMPL = prev


@pytest.mark.parametrize("b,q,n,exact", [
    (3, 100, 25, False), (2, 8, 3, False), (4, 37, 37, False), (2, 150, 40, False),
    (2, 30, 12, True), (2, 1, 1, False),
])
def test_auction_plain_bit_identical_to_xla_and_pallas(b, q, n, exact, monkeypatch):
    """The cases of tests/test_auction.py, with invalid columns, exact mode
    and the trivial q = 1 problem: identical assignments."""
    monkeypatch.setattr(auction_cuda, "LAUNCHES", 0)
    rng = np.random.RandomState(7 + q)
    cost = rng.rand(b, q, n).astype(np.float32) * 10
    valid = rng.rand(b, n) > 0.2
    got = auction.auction_assign(torch.from_numpy(cost), torch.from_numpy(valid), exact=exact)
    assert got.dtype == torch.int32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), _jax_assign(cost, valid, exact))
    if q > 1:
        benefits = auction.build_benefits(torch.from_numpy(cost), torch.from_numpy(valid))
        ref = auction_asym_pallas(jnp.asarray(benefits.numpy()), n, q,
                                  jax_auction._eps_schedule(n, exact), interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the CUDA wrapper on a CPU tensor is the plain auction, no launch
    ben = auction.build_benefits(torch.from_numpy(cost), torch.from_numpy(valid))
    eps = auction.eps_schedule(n, exact)
    assert torch.equal(auction_cuda.auction_asym_cuda(ben, eps), auction.auction_asym_plain(ben, eps))
    assert auction_cuda.LAUNCHES == 0


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), levels=st.sampled_from([2, 3, 5]))
def test_auction_near_ties_bit_identical(seed, levels):
    """Costs on a coarse grid: after quantization many benefits tie, and
    the tie order (lowest index) decides the assignment."""
    rng = np.random.RandomState(seed)
    cost = (rng.randint(0, levels, (3, 12, 6)) / levels).astype(np.float32)
    cost += (rng.rand(3, 12, 6) * 1e-4).astype(np.float32)  # below a quantization unit
    valid = rng.rand(3, 6) > 0.25
    got = auction.auction_assign(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, _jax_assign(cost, valid, False))


def test_grid_sample_rows_matches_jax():
    rng = np.random.RandomState(0)
    rows = rng.randn(2, 6 * 9, 5).astype(np.float32)
    grid = (rng.rand(2, 40, 2) * 2.4 - 1.2).astype(np.float32)  # some outside [-1, 1]
    got = grid_sample_rows(torch.from_numpy(rows), torch.from_numpy(grid), 6, 9).numpy()
    ref = np.asarray(jax_grid_sample_rows(jnp.asarray(rows), jnp.asarray(grid), 6, 9, impl="gather"))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))))
def test_config_loader_matches_jax(path):
    """Every video config, with opts, to the same values as the JAX loader
    (which parses with PyYAML); the port's own YAML reader has no PyYAML."""
    opts = ["SOLVER.BASE_LR", "0.5", "MODEL.MASK_FORMER.TEST.NMS_THRESH", "0.6",
            "DATASETS.TRAIN", '("a", "b")', "SOLVER.STEPS", "(10, 20)"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for o in ((), opts):
            ref = dataclasses.asdict(jax_load_config(path, list(o)))
            got = dataclasses.asdict(load_config_tree(path, o))
            assert got == ref
            assert repr(got) == repr(ref)  # same types (tuples, ints, floats)


def test_schedules_match_jax():
    cfg_opts = ["MODEL.MASK_FORMER.KD_WEIGHT_SCHEDULER", "cosine",
                "MODEL.MASK_FORMER.KD_WEIGHT_DECAY_END", "100.0",
                "MODEL.MASK_FORMER.LOSS_WEIGHT_DECAY_STEP", "80.0",
                "MODEL.MASK_FORMER.EMA_MOMENTUM_SCHEDULE", "True",
                "MODEL.MASK_FORMER.EMA_MOMENTUM", "0.99"]
    jcfg, pcfg = jax_load_config(None, cfg_opts), load_config_tree(None, cfg_opts)
    jlr, plr = jax_lr(1e-4, (50, 90), 0.1, 10, 0.3), schedules.warmup_multistep_lr(1e-4, (50, 90), 0.1, 10, 0.3)
    jf, pf = jax_factors(jcfg, 100), schedules.loss_weight_factors(pcfg, 100)
    je, pe = jax_ema(jcfg), schedules.ema_momentum_schedule(pcfg)
    for step in (0, 3, 10, 49, 50, 79, 80, 95, 120):
        np.testing.assert_allclose(plr(step), float(jlr(step)), rtol=1e-6)
        np.testing.assert_allclose(pf(step), [float(v) for v in jf(step)], rtol=1e-6)
        np.testing.assert_allclose(pe(step), float(je(step)), rtol=1e-6)


def test_label_params_match_jax():
    """The optimizer groups of every parameter of the port's names equal the
    JAX labels of the same flax leaves."""
    from flax.traverse_util import flatten_dict

    from s2d_tpu.models.meta_arch import VideoMaskFormer as JaxVideoMaskFormer
    from s2d_tpu_torch.checkpoint.from_jax import params_to_jax
    from s2d_tpu_torch.config import VideoConfig
    from s2d_tpu_torch.models.meta_arch import build_model

    cfg = VideoConfig(hidden_dim=32, mask_dim=32, num_queries=4, nheads=4, dim_feedforward=32,
                      dec_layers=2, enc_layers=1, amp=False)
    model = build_model(cfg, seed=None)
    jax_model = JaxVideoMaskFormer(hidden_dim=32, mask_dim=32, num_queries=4, nheads=4,
                                   dim_feedforward=32, dec_layers=2, transformer_enc_layers=1)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 64, 64, 3)))
    ref = {"/".join(k): v for k, v in flatten_dict(jax_label_params(shapes)).items()}
    got = label_params([n for n, _ in model.named_parameters()])
    assert set(params_to_jax(model.state_dict())) == set(ref)
    for name, label in got.items():
        key = next(iter(params_to_jax({name: model.state_dict()[name]})))
        assert label == ref[key], name
    assert sum(lab == "frozen" for lab in got.values()) == 2 * 53  # R50 FrozenBN affines


@pytest.mark.parametrize("opts,workers", [
    ([], 4),
    (["SOLVER.REFERENCE_WORLD_SIZE", "2", "SOLVER.ACCUM_ITER", "3"], 8),
    (["SOLVER.REFERENCE_WORLD_SIZE", "8", "SOLVER.IMS_PER_BATCH", "16"], 2),
])
def test_scaling_matches_jax(opts, workers):
    """The worker and gradient-accumulation scaling rules give the same
    solver fields as the JAX package's."""
    from s2d_tpu.train import scaling as jax_scaling

    from s2d_tpu_torch.train import scaling

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg, pcfg = jax_load_config(None, opts), load_config_tree(None, opts)
    ref = jax_scaling.apply_accum_lr_scale(jax_scaling.auto_scale_workers(jcfg, workers))
    got = scaling.apply_accum_lr_scale(scaling.auto_scale_workers(pcfg, workers))
    assert dataclasses.asdict(got.solver) == dataclasses.asdict(ref.solver)
