"""The port's KD train slice against the JAX package, on the CPU: matcher
costs and assignments, the criterion pair, the optimizer, and one and two
train steps of `make_train_step`.

Random draws: JAX draws the criterion's point pool and Bernoulli weights
from its own keys (`trainer.py:256-257`, `criterion.py:406`). The tests
rebuild those key splits and hand the arrays to the port (`draws`), so both
see the same points. DROPOUT is 0 in the step tests.

Tolerances, and why:
  * matcher costs rtol 1e-5: f32 on both sides, other summation orders;
  * assignments identical: the auction is exact on the quantized costs;
  * criterion losses rtol 1e-5 / atol 1e-6 (f32), step losses and metrics
    rtol 1e-4 (a whole model forward before them);
  * clipped gradients rtol 1e-3 / atol 1e-7 (backward through the model;
    the clip scales every gradient to a global norm of 0.01);
  * the optimizer, fed identical gradients, rtol 1e-6 on the parameters.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import jax
import jax.numpy as jnp

from s2d_tpu.config import load_config as jax_load_config
from s2d_tpu.losses import criterion as jax_criterion
from s2d_tpu.losses.matcher import hungarian_assign as jax_hungarian
from s2d_tpu.models.meta_arch import VideoMaskFormer as JaxVideoMaskFormer
from s2d_tpu.train import TrainState as JaxTrainState
from s2d_tpu.train import build_optimizer as jax_build_optimizer
from s2d_tpu.train import make_train_step as jax_make_train_step

from s2d_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from s2d_tpu_torch.config import from_s2d_config, load_config_tree
from s2d_tpu_torch.losses import criterion
from s2d_tpu_torch.losses.matcher import hungarian_assign, hungarian_assign_scipy
from s2d_tpu_torch.models.meta_arch import build_model
from s2d_tpu_torch.ops import auction_cuda, ms_deform_attn_cuda
from s2d_tpu_torch.train.optim import KDOptimizer
from s2d_tpu_torch.train.trainer import create_train_state, make_train_step


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = [
    "MODEL.MASK_FORMER.HIDDEN_DIM", "32", "MODEL.SEM_SEG_HEAD.MASK_DIM", "32",
    "MODEL.SEM_SEG_HEAD.CONVS_DIM", "32", "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "8",
    "MODEL.MASK_FORMER.NHEADS", "4", "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "64",
    "MODEL.MASK_FORMER.DEC_LAYERS", "2", "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1",
    "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64", "SOLVER.AMP.ENABLED", "False",
]
B, T, H, W, N = 1, 2, 32, 32, 3


def _np(x):
    return np.array(x, dtype=np.float32)


def _draws(k_sup, num_points, oversample, importance, rows):
    """JAX's criterion draws from k_sup, as `_criterion_costs_multi` makes
    them: the pool, and one Bernoulli draw per row count (shared key)."""
    _, k_pool, k_bern = jax.random.split(k_sup, 3)
    s = int(num_points * oversample)
    num_random = num_points - int(importance * num_points)
    pool = jax.random.uniform(k_pool, (s, 2))
    bern = {r: torch.from_numpy(np.array(jax.random.uniform(k_bern, (r, s)) < (num_random / s)))
            for r in dict.fromkeys(rows)}
    return {"pool": torch.from_numpy(_np(pool)), "bern": bern}


# --------------------------------------------------------------------------
# matcher and criterion on random predictions
# --------------------------------------------------------------------------


def _outputs(rng, b, q, t, h, w, layers):
    mk = lambda: (rng.randn(b, q, 2).astype(np.float32),
                  (3 * rng.randn(b, q, t, h, w)).astype(np.float32))
    final, aux = mk(), [mk() for _ in range(layers - 1)]
    return {"pred_logits": final[0], "pred_masks": final[1],
            "aux_pred_logits": [a[0] for a in aux], "aux_pred_masks": [a[1] for a in aux]}


def _targets(rng, b, n, t, h, w, valid):
    masks = rng.rand(b, n, t, h, w) > 0.6
    masks[0, 1, 1] = False  # an empty frame: DropLoss drops that row
    return masks, np.asarray(valid, bool)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree))


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree)


CRIT_CASE = dict(num_points=200, oversample_ratio=3.0, importance_sample_ratio=0.75)


@pytest.fixture(scope="module")
def crit_case():
    rng = np.random.RandomState(0)
    q, t, hp, wp = 10, 2, 8, 12
    outputs = _outputs(rng, 2, q, t, hp, wp, layers=3)
    sup = _targets(rng, 2, 4, t, 4 * hp, 4 * wp, [[True, True, True, False], [True, False, True, True]])
    kd = _targets(rng, 2, q, t, 4 * hp, 4 * wp, rng.rand(2, q) > 0.4)
    k_sup = jax.random.PRNGKey(5)
    rows = [2 * 4 * t, 2 * q * t]
    return outputs, sup, kd, k_sup, _draws(k_sup, 200, 3.0, 0.75, rows)


@pytest.mark.parametrize("amp", [False, True])
def test_criterion_pair_matches_jax(crit_case, amp):
    """Costs, assignments and every loss of the pair (aux layers too), with
    JAX's own draws. AMP: both sample the predictions in bf16 (each
    bilinear term rounded) and run the loss chain in bf16 with f32 sums;
    the target values at the pool are JAX's f32 values cast to bf16,
    exactly. The losses are held at rtol 2e-4 (measured 8.4e-5: bf16
    rounding in another op order). The port's f32 loss chain against JAX's
    bf16 one misses by 6.0e-4, so the bound tells the cast points apart."""
    outputs, (sm, sv), (km, kv), k_sup, draws = crit_case
    dt = (jnp.bfloat16, torch.bfloat16) if amp else (jnp.float32, torch.float32)
    jcfg = jax_criterion.CriterionConfig(
        **CRIT_CASE, gather_dtype=dt[0],
        bwd_einsum_precision=jax.lax.Precision.DEFAULT if amp else jax.lax.Precision.HIGHEST)
    pcfg = criterion.CriterionConfig(**CRIT_CASE, gather_dtype=dt[1], assign_impl="plain")
    jout = _to_jax(outputs)
    ref_sup, ref_kd = jax_criterion.set_criterion_pair(
        k_sup, jout, jnp.asarray(sm), jnp.asarray(sv), jcfg,
        k_sup, jout, jnp.asarray(km), jnp.asarray(kv), jcfg)
    pout = _to_torch(outputs)
    args = (torch.from_numpy(sm), torch.from_numpy(sv), pcfg,
            torch.from_numpy(km), torch.from_numpy(kv), pcfg)
    got_sup, got_kd = criterion.set_criterion_pair(pout, *args, draws=draws)
    rtol, atol = (2e-4, 1e-6) if amp else (1e-5, 1e-6)
    for got, ref in ((got_sup, ref_sup), (got_kd, ref_kd)):
        assert list(got) == list(ref)  # same keys, same order
        for key in ref:
            np.testing.assert_allclose(got[key].detach().numpy(), _np(ref[key]),
                                       rtol=rtol, atol=atol, err_msg=key)
    # costs and assignments, stage by stage
    j_states = jax_criterion._criterion_costs_multi(
        k_sup, jout, [(jnp.asarray(sm), jnp.asarray(sv), jcfg), (jnp.asarray(km), jnp.asarray(kv), jcfg)])
    p_states = criterion._criterion_costs_multi(pout, [args[:3], args[3:]], draws=draws)
    if amp:
        for js, ps in zip(j_states, p_states):
            assert ps["pool_tgt"].dtype == torch.bfloat16
            ref_tgt = torch.from_numpy(_np(js["pool_tgt"])).to(torch.bfloat16)
            assert torch.equal(ps["pool_tgt"], ref_tgt)
        return
    for js, ps in zip(j_states, p_states):
        np.testing.assert_allclose(ps["stacked_cost"].numpy(), _np(js["stacked_cost"]), rtol=1e-5)
        np.testing.assert_allclose(ps["pool_tgt"].numpy(), _np(js["pool_tgt"]), rtol=1e-6, atol=1e-7)
        ref_assign = np.asarray(jax_hungarian(js["stacked_cost"], js["stacked_valid"]))
        got_assign = hungarian_assign(ps["stacked_cost"], ps["stacked_valid"]).numpy()
        np.testing.assert_array_equal(got_assign, ref_assign)
        # every valid slot is matched to a distinct query, near scipy's optimum
        lsa = hungarian_assign_scipy(ps["stacked_cost"]).numpy()
        cost = ps["stacked_cost"].numpy()
        for i, v in enumerate(ps["stacked_valid"].numpy()):
            sub = cost[i][:, v]
            gap = sub[got_assign[i][v], np.arange(v.sum())].sum() - sub[lsa[i][v], np.arange(v.sum())].sum()
            assert gap <= 0.01 * (sub.max() - sub.min()) * v.sum() + 1e-6
    assert ms_deform_attn_cuda.LAUNCHES == auction_cuda.LAUNCHES == 0


def test_matcher_points_and_costs_match_jax(crit_case):
    """`sample_match_points` on JAX's point draw and `match_costs` (with a
    class cost) against the JAX matcher: rtol 1e-5, f32 on both sides."""
    from s2d_tpu.losses.matcher import match_costs as jax_match_costs
    from s2d_tpu.losses.matcher import sample_match_points as jax_sample_match_points

    from s2d_tpu_torch.losses.matcher import match_costs, sample_match_points

    outputs, (sm, sv), _, _, _ = crit_case
    key = jax.random.PRNGKey(9)
    jp, jt = jax_sample_match_points(key, jnp.asarray(outputs["pred_masks"]), jnp.asarray(sm), 50)
    coords = torch.from_numpy(_np(jax.random.uniform(key, (sm.shape[0], 50, 2))))
    pp, pt = sample_match_points(coords, torch.from_numpy(outputs["pred_masks"]), torch.from_numpy(sm))
    np.testing.assert_allclose(pp.numpy(), _np(jp), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), _np(jt), rtol=1e-6, atol=1e-6)
    ref = jax_match_costs(jnp.asarray(outputs["pred_logits"]), jnp.asarray(outputs["pred_masks"]),
                          jt, jp, jnp.asarray(sv), 2.0, 5.0, 5.0)
    got = match_costs(torch.from_numpy(outputs["pred_logits"]), pt, pp, 2.0, 5.0, 5.0)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-5, atol=1e-6)


def test_criterion_droploss_and_padding_invariance(crit_case):
    """An empty target frame contributes nothing, and invalid padded target
    slots change no loss (given the same draws on the real rows)."""
    outputs, (sm, sv), _, _, draws = crit_case
    pcfg = criterion.CriterionConfig(**CRIT_CASE, assign_impl="plain")
    pout = _to_torch(outputs)
    rows = sm.shape[0] * sm.shape[1] * sm.shape[2]
    d1 = {"pool": draws["pool"], "bern": {rows: draws["bern"][rows]}}
    base = criterion.set_criterion(pout, torch.from_numpy(sm), torch.from_numpy(sv), pcfg, draws=d1)
    # pad with two invalid slots per video (random masks), on video 0 only
    pad_m = np.concatenate([sm, np.random.RandomState(1).rand(2, 2, *sm.shape[2:]) > 0.5], axis=1)
    pad_v = np.concatenate([sv, np.zeros((2, 2), bool)], axis=1)
    rows_p = pad_m.shape[0] * pad_m.shape[1] * pad_m.shape[2]
    bern = torch.zeros(rows_p, d1["pool"].shape[0], dtype=torch.bool)
    per_video = sm.shape[1] * sm.shape[2]
    for b in range(2):  # the real rows keep their draws
        bern[b * (per_video + 4): b * (per_video + 4) + per_video] = d1["bern"][rows][b * per_video: (b + 1) * per_video]
    padded = criterion.set_criterion(pout, torch.from_numpy(pad_m), torch.from_numpy(pad_v), pcfg,
                                     draws={"pool": d1["pool"], "bern": {rows_p: bern}})
    for key in base:
        np.testing.assert_allclose(padded[key].numpy(), base[key].numpy(), rtol=1e-5, err_msg=key)
    # DropLoss: slot 1 of video 0 is empty in frame 1; its prediction there
    # does not move the loss
    st = criterion._criterion_costs_multi(
        pout, [(torch.from_numpy(sm), torch.from_numpy(sv), pcfg)], draws=d1)[0]
    assert not bool(st["row_keep"][0, 1, 1]) and bool(st["row_keep"][0, 1, 0])


# --------------------------------------------------------------------------
# the optimizer, fed identical gradients
# --------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_optax_chain(accum):
    """Clip -> Adam -> decay -> group multiplier -> -lr(step), and ACCUM_ITER
    averaging as optax.MultiSteps, over two optimizer updates."""
    cfg_opts = TINY + ["SOLVER.ACCUM_ITER", str(accum), "SOLVER.WARMUP_ITERS", "1",
                       "SOLVER.WARMUP_FACTOR", "0.5"]
    cfg = load_config_tree(None, cfg_opts)
    model = build_model(from_s2d_config(cfg), seed=3)
    jcfg = jax_load_config(None, cfg_opts)
    flat = params_to_jax(model.state_dict())
    jparams = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    tx = jax_build_optimizer(jcfg, jparams)
    opt_state = tx.init(jparams)
    update = jax.jit(lambda g, st, p: tx.update(g, st, p))
    opt = KDOptimizer(list(model.named_parameters()), cfg)
    rng = np.random.RandomState(4)
    for i in range(2 * accum):
        # one gradient set of a large norm (clipped), one small (not clipped)
        scale = 1.0 if i % 2 == 0 else 1e-5
        grads = {k: (scale * rng.randn(*v.shape)).astype(np.float32) for k, v in flat.items()}
        updates, opt_state = update(
            unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in grads.items()}),
            opt_state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        port_grads = params_from_jax(grads, model.state_dict())
        opt.step([port_grads[n] for n in opt.names])
    ref = params_from_jax({"/".join(k): np.asarray(v) for k, v in flatten_dict(jparams).items()},
                          model.state_dict())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    assert not torch.equal(model.state_dict()["predictor.class_embed.weight"],
                           params_from_jax(flat, model.state_dict())["predictor.class_embed.weight"])
    assert opt.count == 2


# --------------------------------------------------------------------------
# one and two train steps of make_train_step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_steps():
    """Two jitted JAX KD steps from seeded params, with their states."""
    cfg = jax_load_config(None, TINY)
    mf = cfg.model.mask_former
    model = JaxVideoMaskFormer(
        num_classes=1, hidden_dim=mf.hidden_dim, mask_dim=32, num_queries=mf.num_object_queries,
        nheads=mf.nheads, dim_feedforward=mf.dim_feedforward, dec_layers=mf.dec_layers,
        transformer_enc_layers=1, compute_dtype=jnp.float32)
    rng = np.random.RandomState(0)
    images = rng.randn(B, T, H, W, 3).astype(np.float32)
    masks = rng.rand(B, N, T, H, W) > 0.7
    masks[0, 0, 1] = False  # an empty frame
    valid = np.array([[True, True, False]])
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(images))
    tx = jax_build_optimizer(cfg, params)
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                          teacher_params=jax.tree_util.tree_map(jnp.copy, params),
                          opt_state=tx.init(params))
    step_fn = jax.jit(jax_make_train_step(model, cfg, tx))
    key = jax.random.PRNGKey(2)
    states, metrics = [state], []
    for _ in range(2):
        state, m = step_fn(state, jnp.asarray(images), jnp.asarray(masks), jnp.asarray(valid), key)
        states.append(state)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(images=images, masks=masks, valid=valid, key=key, states=states, metrics=metrics)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _port_state(jax_state, cfg):
    state = create_train_state(cfg, device="cpu", params=_flat(jax_state.params))
    teacher = params_from_jax(_flat(jax_state.teacher_params), state.teacher.state_dict())
    state.teacher.load_state_dict(teacher)
    state.step = int(jax_state.step)
    return state


def _step_draws(key, step, rows):
    k_sup = jax.random.split(jax.random.fold_in(key, step), 3)[1]
    return _draws(k_sup, 64, 3.0, 0.75, rows)


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_matches_jax(jax_steps, step):
    """From JAX's state before step `step`: the port's losses and metrics,
    its clipped gradients (FrozenBN included in the norm), and its optimizer
    update given JAX's clipped gradients."""
    cfg = load_config_tree(None, TINY)
    state = _port_state(jax_steps["states"][step], cfg)
    train_step = make_train_step(cfg)
    draws = _step_draws(jax_steps["key"], step, [B * N * T, B * 8 * T])
    images, masks, valid = (torch.from_numpy(jax_steps[k]) for k in ("images", "masks", "valid"))
    total, metrics, grads = train_step.loss_and_grads(state, images, masks, valid, draws=draws)
    ref = jax_steps["metrics"][step]
    for key, value in metrics.items():
        np.testing.assert_allclose(float(value), ref[key], rtol=1e-4, err_msg=key)

    # JAX's clipped gradients from its Adam first moments:
    # mu_k = 0.1 g_k + 0.9 mu_{k-1}
    mu = [_flat(s.opt_state[1].mu) for s in jax_steps["states"][: step + 2]]
    ref_grads = {k: (mu[step + 1][k] - np.float32(0.9) * mu[step][k]) / np.float32(0.1)
                 for k in mu[0]}
    ref_grads = params_from_jax(ref_grads, state.student.state_dict())
    clipped = state.optimizer.clip_gradients(grads)
    for name, g in zip(state.optimizer.names, clipped):
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), rtol=1e-3, atol=1e-7,
                                   err_msg=name)
    assert any("norm" in n and float(g.abs().max()) > 0 for n, g in zip(state.optimizer.names, clipped)
               if n.startswith("backbone"))  # FrozenBN gradients exist

    if step == 0:  # the optimizer on JAX's own gradients, then the EMA
        state.optimizer.step([ref_grads[n] for n in state.optimizer.names])
        after = params_from_jax(_flat(jax_steps["states"][1].params), state.student.state_dict())
        for name, p in state.student.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(), rtol=1e-6,
                                       atol=1e-9, err_msg=name)


def test_full_step_ema_and_nan_skip(jax_steps):
    """A whole port step: finite losses, the student moved, FrozenBN held,
    the teacher the EMA of the new student; then a non-finite step holds
    parameters, moments and teacher."""
    cfg = load_config_tree(None, TINY)
    state = _port_state(jax_steps["states"][0], cfg)
    train_step = make_train_step(cfg)
    images, masks, valid = (torch.from_numpy(jax_steps[k]) for k in ("images", "masks", "valid"))
    before = {k: v.clone() for k, v in state.student.state_dict().items()}
    teacher0 = {k: v.clone() for k, v in state.teacher.state_dict().items()}
    state, metrics = train_step(state, images, masks, valid, generator=torch.Generator().manual_seed(0))
    assert state.step == 1 and float(metrics["grad_finite"]) == 1.0
    assert all(np.isfinite(float(v)) for v in metrics.values())
    after = state.student.state_dict()
    assert not torch.equal(after["predictor.class_embed.weight"], before["predictor.class_embed.weight"])
    assert torch.equal(after["backbone.stem_norm1.weight"], before["backbone.stem_norm1.weight"])
    m = np.float32(cfg.model.mask_former.ema_momentum)
    for name, t in state.teacher.state_dict().items():
        np.testing.assert_allclose(t.numpy(), (m * teacher0[name] + (1 - m) * after[name]).numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)

    held = {k: v.clone() for k, v in state.student.state_dict().items()}
    held_t = {k: v.clone() for k, v in state.teacher.state_dict().items()}
    held_mu = [t.clone() for t in state.optimizer.mu]
    bad = images.clone()
    bad[0, 0, 0, 0, 0] = float("nan")
    state, metrics = train_step(state, bad, masks, valid, generator=torch.Generator().manual_seed(1))
    assert state.step == 2 and float(metrics["grad_finite"]) == 0.0
    for k, v in state.student.state_dict().items():
        assert torch.equal(v, held[k]), k
    for k, v in state.teacher.state_dict().items():
        assert torch.equal(v, held_t[k]), k
    assert all(torch.equal(a, b) for a, b in zip(state.optimizer.mu, held_mu))
    assert state.optimizer.count == 1


def test_ema_only_on_accumulation_boundaries():
    """ACCUM_ITER 2: the first micro-step moves neither the student nor the
    teacher; the second moves both."""
    cfg = load_config_tree(None, TINY + ["SOLVER.ACCUM_ITER", "2"])
    state = create_train_state(cfg, seed=1, device="cpu")
    train_step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(B, T, H, W, 3, generator=gen)
    masks = torch.rand(B, N, T, H, W, generator=gen) > 0.7
    valid = torch.tensor([[True, True, False]])
    s0 = {k: v.clone() for k, v in state.student.state_dict().items()}
    t0 = {k: v.clone() for k, v in state.teacher.state_dict().items()}
    state, _ = train_step(state, images, masks, valid, generator=gen)
    assert all(torch.equal(v, s0[k]) for k, v in state.student.state_dict().items())
    assert all(torch.equal(v, t0[k]) for k, v in state.teacher.state_dict().items())
    state, _ = train_step(state, images, masks, valid, generator=gen)
    key = "predictor.class_embed.weight"
    assert not torch.equal(state.student.state_dict()[key], s0[key])
    assert not torch.equal(state.teacher.state_dict()[key], t0[key])


@pytest.mark.parametrize("opts", [
    ["MODEL.MASK_FORMER.DISTILLATION_NMS", "True"],
    ["INPUT.DISENTANGLE_DISTILLATION_LOADER", "True"],
    ["MODEL.MASK_FORMER.POINT_SAMPLING", "lattice"],
])
def test_unported_train_options_raise(opts):
    """Each option is ported: the step builds with it (it raised before it
    was ported). As in JAX, NUM_PREDICTIONS_DISTILLATION below the query
    count still raises, with each option too."""
    make_train_step(load_config_tree(None, TINY + opts))
    with pytest.raises(NotImplementedError, match="NUM_PREDICTIONS_DISTILLATION"):
        make_train_step(load_config_tree(
            None, TINY + opts + ["MODEL.MASK_FORMER.NUM_PREDICTIONS_DISTILLATION", "4"]))


# --------------------------------------------------------------------------
# the parameter mapping and the import rule
# --------------------------------------------------------------------------


def test_params_to_jax_round_trip_full_size():
    """Every tensor of the full-size port maps to exactly one flax leaf of
    the JAX model (names and shapes), and back to itself."""
    cfg = load_config_tree()
    vcfg = from_s2d_config(cfg)
    jax_model = JaxVideoMaskFormer(
        num_classes=vcfg.num_classes, hidden_dim=vcfg.hidden_dim, num_queries=vcfg.num_queries,
        nheads=vcfg.nheads, dim_feedforward=vcfg.dim_feedforward, dec_layers=vcfg.dec_layers,
        transformer_enc_layers=vcfg.enc_layers)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 64, 64, 3)))
    ref = {"/".join(k): v.shape for k, v in flatten_dict(shapes).items()}
    model = build_model(vcfg, seed=0)
    flat = params_to_jax(model.state_dict())
    assert {k: v.shape for k, v in flat.items()} == ref
    back = params_from_jax(flat, model.state_dict())
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t), name


def test_train_slice_imports_no_jax(tmp_path):
    """With jax, s2d_tpu, cv2 and PIL blocked on import, the port loads a YAML config,
    builds a train state on the CPU and runs one tiny step; lazy imports
    inside functions would fail here."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'yaml', 's2d_tpu',\n"
        "                                  'cv2', 'PIL'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "from s2d_tpu_torch.config import load_config_tree\n"
        "from s2d_tpu_torch.train.trainer import create_train_state, make_train_step\n"
        "import chip_smoke\n"
        f"cfg = load_config_tree('configs/ytvis2021_kd_video_mask2former_R50_cls_agnostic.yaml', {TINY!r})\n"
        "assert cfg.model.weights == 'vm2f_sparse_keymask.pth' and cfg.model.mask_former.dropout == 0.3\n"
        "state = create_train_state(cfg, seed=0, device='cpu')\n"
        "gen = torch.Generator().manual_seed(0)\n"
        "images = torch.randn(1, 2, 32, 32, 3, generator=gen)\n"
        "masks = torch.rand(1, 3, 2, 32, 32, generator=gen) > 0.7\n"
        "state, m = make_train_step(cfg)(state, images, masks, torch.tensor([[True, True, False]]),"
        " generator=gen)\n"
        "assert float(m['grad_finite']) == 1.0, m\n"
    )
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
