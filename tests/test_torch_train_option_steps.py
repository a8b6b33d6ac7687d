"""One KD train step with each option of the step, alone and all four
together, in the port against the JAX package's `make_train_step`, on the
CPU: MODEL.MASK_FORMER.DISTILLATION_NMS, the disentangled distillation view
(INPUT.DISENTANGLE_DISTILLATION_LOADER: a second student forward on the
distillation images, the teacher's targets warped into them), POINT_SAMPLING
lattice, and targets bit-packed along W; and, in the port alone, packed
targets against bool ones and the disentangled step's second forward
replaying the first one's dropout draw.

The networks are a small stand-in written twice, in jnp and in torch, the
same function of the same parameters: per query an ellipse of mask logits
at stride 4 plus a linear map of the 4x4-pooled colours, a class head on
the pooled mean, and aux layers scaling the masks. What these tests hold is
the step around the network (targets, warp, NMS, the criterion pair and
its draws); the networks themselves are held to JAX by
tests/test_torch_train.py. A stand-in keeps JAX's compile of each step to
seconds: the R50 step compiles in about half a minute on the CPU.

JAX's random draws are rebuilt from its keys and handed to the port
(`draws=`: the supervised criterion's from k_sup; with the disentangled
view the distillation criterion's from k_kd, under "kd"). The scores are
set away from the distillation threshold and the duplicate queries far
above the NMS threshold, so no hard decision sits near its threshold; the
losses are held at rtol 1e-3 / atol 2e-3 (f32); the distillation NMS
drops the duplicate query and keeps the other targets.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2d_tpu.config import load_config as jax_load_config
from s2d_tpu.train import TrainState as JaxTrainState
from s2d_tpu.train import build_optimizer as jax_build_optimizer
from s2d_tpu.train import make_train_step as jax_make_train_step

from s2d_tpu_torch.config import load_config_tree
from s2d_tpu_torch.ops import lattice
from s2d_tpu_torch.train import trainer
from s2d_tpu_torch.train.optim import KDOptimizer

B, T, H, W, N, Q, LAYERS = 2, 2, 32, 40, 3, 8, 2
BASE = ["MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", str(Q), "MODEL.MASK_FORMER.DEC_LAYERS",
        str(LAYERS + 1), "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64", "SOLVER.AMP.ENABLED",
        "False", "MODEL.MASK_FORMER.DROPOUT", "0.0"]
OPTIONS = {
    "nms": ["MODEL.MASK_FORMER.DISTILLATION_NMS", "True"],
    "disentangle": ["INPUT.DISENTANGLE_DISTILLATION_LOADER", "True"],
    "lattice": ["MODEL.MASK_FORMER.POINT_SAMPLING", "lattice"],
    "packed": [],
}


def _params():
    """The stand-in's parameters: query q's mask an ellipse at stride 4
    (queries 0 and 1 the same one: NMS drops 1; 4-7 elsewhere), foreground
    logits that put queries 0-3 at a score of 0.88 (over the 0.75 of
    SCORE_THRESHOLD_DISTILLATION) and the rest at 0.27."""
    rng = np.random.RandomState(0)
    h4, w4 = H // 4, W // 4
    yy, xx = np.mgrid[:h4, :w4]
    centres = [(2, 2), (2, 2), (5, 7), (2, 7), (5, 2), (4, 4), (6, 8), (1, 5)]
    bias = np.stack([4 * (1 - ((yy - cy) / 1.7) ** 2 - ((xx - cx) / 2.2) ** 2)
                     for cy, cx in centres]).clip(-6, 6)
    b_cls = np.zeros((Q, 2))
    b_cls[:4, 0], b_cls[4:, 0] = 2.0, -1.0
    return {"w_mask": 0.2 * rng.randn(Q, 3), "bias": bias, "w_cls": 0.05 * rng.randn(3, 2),
            "b_cls": b_cls, "scale": np.array([0.7, 1.0])}


def _jax_forward(p, images):
    b, t, h, w, _ = images.shape
    pooled = images.reshape(b, t, h // 4, 4, w // 4, 4, 3).mean(axis=(3, 5))
    base = jnp.einsum("bthwc,qc->bqthw", pooled, p["w_mask"]) + p["bias"][None, :, None]
    logits = (pooled.mean(axis=(1, 2, 3)) @ p["w_cls"])[:, None, :] + p["b_cls"][None]
    layers = [(logits * s, base * s) for s in p["scale"]]
    return {"pred_logits": layers[-1][0], "pred_masks": layers[-1][1],
            "aux_pred_logits": [l for l, _ in layers[:-1]],
            "aux_pred_masks": [m for _, m in layers[:-1]]}


class _JaxStandIn:
    def apply(self, variables, images, deterministic=True, rngs=None, frame_valid=None):
        return _jax_forward(variables["params"], images)


class _TorchStandIn(torch.nn.Module):
    """The stand-in in torch; with `dropout`, the mask logits are dropped
    out in train mode with a draw from the step's generator (as the real
    encoder's dropout)."""

    def __init__(self, params, dropout=0.0):
        super().__init__()
        self.dropout = dropout
        for k, v in params.items():
            self.register_parameter(k, torch.nn.Parameter(torch.tensor(v, dtype=torch.float32)))

    def forward(self, images, generator=None, frame_valid=None):
        b, t, h, w, _ = images.shape
        pooled = images.reshape(b, t, h // 4, 4, w // 4, 4, 3).mean(dim=(3, 5))
        base = torch.einsum("bthwc,qc->bqthw", pooled, self.w_mask) + self.bias[None, :, None]
        if self.dropout and self.training:
            keep = torch.rand(base.shape, generator=generator) >= self.dropout
            base = base * keep / (1.0 - self.dropout)
        logits = (pooled.mean(dim=(1, 2, 3)) @ self.w_cls)[:, None, :] + self.b_cls[None]
        layers = [(logits * s, base * s) for s in self.scale]
        return {"pred_logits": layers[-1][0], "pred_masks": layers[-1][1],
                "aux_pred_logits": [l for l, _ in layers[:-1]],
                "aux_pred_masks": [m for _, m in layers[:-1]]}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(1)
    images = rng.randn(B, T, H, W, 3).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    cy, cx = rng.uniform(8, 24, (B, N, T, 1, 1)), rng.uniform(8, 32, (B, N, T, 1, 1))
    masks = ((yy - cy) / 6) ** 2 + ((xx - cx) / 8) ** 2 < 1
    masks[0, 0, 1] = False  # an empty frame (DropLoss)
    valid = np.array([[True, True, False], [True, False, True]])
    # the distillation view: each clip flipped, then shifted by whole pixels
    affine = np.tile(np.eye(3, dtype=np.float32), (B, T, 1, 1))
    distill = np.zeros_like(images)
    for b in range(B):
        for t in range(T):
            dx = 2 * b + t
            affine[b, t, 0] = [-1, 0, W - 1 - dx]
            distill[b, t, :, : W - dx] = images[b, t, :, ::-1][:, dx:]
    return images, masks, valid, distill, affine


def _draws(key, rows, sizes, phases):
    """The criterion's draws from `key`, as JAX's `_criterion_costs_multi`
    makes them: the pool (or the lattice phases) and a Bernoulli draw per
    row count from one key."""
    _, k_pool, k_bern = jax.random.split(key, 3)
    num_points, s = sizes
    num_random = num_points - int(0.75 * num_points)
    out = {"bern": {r: torch.from_numpy(np.array(jax.random.uniform(k_bern, (r, s))
                                                  < num_random / s)) for r in rows}}
    if phases:
        out["phases"] = torch.from_numpy(np.array(jax.random.uniform(k_pool, (2, 2))))
    else:
        out["pool"] = torch.from_numpy(np.array(jax.random.uniform(k_pool, (s, 2))))
    return out


def _port_state(cfg, dropout=0.0):
    student = _TorchStandIn(_params(), dropout)
    teacher = _TorchStandIn(_params()).eval().requires_grad_(False)
    return trainer.TrainState(0, student, teacher,
                              KDOptimizer(list(student.named_parameters()), cfg))


@pytest.mark.parametrize("options", ["nms", "disentangle", "lattice", "packed", "all"])
def test_train_step_option_matches_jax(batch, options, monkeypatch):
    names = list(OPTIONS) if options == "all" else [options]
    opts = BASE + [x for name in names for x in OPTIONS[name]]
    disentangle, packed = "disentangle" in names, "packed" in names
    use_lattice = "lattice" in names
    images, masks, valid, distill, affine = batch
    tgt = np.packbits(masks, axis=-1) if packed else masks

    jcfg = jax_load_config(None, opts)
    params = {"params": jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), _params())}
    tx = jax_build_optimizer(jcfg, params)
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params, teacher_params=params,
                          opt_state=tx.init(params))
    key = jax.random.PRNGKey(2)
    kw = dict(distill_images=jnp.asarray(distill), distill_affine=jnp.asarray(affine)) \
        if disentangle else {}
    step = jax.jit(jax_make_train_step(_JaxStandIn(), jcfg, tx))
    _, ref = step(state, jnp.asarray(images), jnp.asarray(tgt), jnp.asarray(valid), key, **kw)
    ref = {k: float(v) for k, v in ref.items()}

    cfg = load_config_tree(None, opts)
    pstate = _port_state(cfg)
    num_sampled, p = 192, 64
    if use_lattice:
        ly, lx = lattice.choose_lattice(num_sampled, (H // 4, H), (W // 4, W))
        num_sampled = ly * lx
    _, k_sup, k_kd = jax.random.split(jax.random.fold_in(key, 0), 3)
    rows_sup, rows_kd = B * N * T, B * Q * T
    if disentangle:
        draws = _draws(k_sup, [rows_sup], (p, num_sampled), use_lattice)
        draws["kd"] = _draws(k_kd, [rows_kd], (p, num_sampled), use_lattice)
    else:
        draws = _draws(k_sup, [rows_sup, rows_kd], (p, num_sampled), use_lattice)
    validity = []
    own_nms = trainer.distillation_nms

    def nms(*args, **kwargs):
        validity.append((args[2].clone(), own_nms(*args, **kwargs)))
        return validity[-1][1]

    monkeypatch.setattr(trainer, "distillation_nms", nms)
    view = dict(distill_images=torch.from_numpy(distill), distill_affine=torch.from_numpy(affine)) \
        if disentangle else {}
    _, got, _ = trainer.make_train_step(cfg).loss_and_grads(
        pstate, torch.from_numpy(images), torch.from_numpy(tgt), torch.from_numpy(valid),
        draws=draws, **view)
    for k, v in got.items():
        np.testing.assert_allclose(float(v), ref[k], rtol=1e-3, atol=2e-3, err_msg=k)
    assert got["kd_loss_mask"] > 0 and got["loss_mask"] > 0

    if "nms" in names:  # (its validity is held to JAX's in test_torch_train_options.py)
        (before, after), = validity
        assert before[:, :4].all() and not before[:, 4:].any()
        assert after[:, [0, 2, 3]].all() and not after[:, 1].any() and not after[:, 4:].any()
    else:
        assert not validity


def test_packed_targets_bit_identical_to_bool(batch):
    """Targets bit-packed along W give the bool targets' losses and
    gradients bit for bit; a uint8 array of another width raises."""
    images, masks, valid, _, _ = batch
    cfg = load_config_tree(None, BASE)
    state, step = _port_state(cfg), trainer.make_train_step(cfg)
    packed = torch.from_numpy(np.packbits(masks, axis=-1))
    assert packed.dtype == torch.uint8 and packed.shape[-1] == W // 8
    args = (torch.from_numpy(images), None, torch.from_numpy(valid))
    runs = [step.loss_and_grads(state, args[0], m, args[2], torch.Generator().manual_seed(3))
            for m in (torch.from_numpy(masks), packed)]
    (t0, m0, g0), (t1, m1, g1) = runs
    assert torch.equal(t0, t1) and m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert torch.equal(trainer.unpack_targets(packed, W), torch.from_numpy(masks))
    with pytest.raises(ValueError, match="bit-packed"):
        step.loss_and_grads(state, args[0], torch.from_numpy(masks).to(torch.uint8), args[2])


def test_distill_forward_replays_the_dropout_draw(batch, monkeypatch):
    """The second student forward (the distillation view) uses the first
    one's dropout draw: on the same images the two outputs are equal bit
    for bit, though dropout is on (a third forward with the generator as
    it stands draws other masks)."""
    images, masks, valid, _, _ = batch
    cfg = load_config_tree(None, BASE + OPTIONS["disentangle"])
    state = _port_state(cfg, dropout=0.5)
    outs = []
    own = state.student.forward

    def forward(*args, **kwargs):
        outs.append(own(*args, **kwargs))
        return outs[-1]

    monkeypatch.setattr(state.student, "forward", forward)
    gen = torch.Generator().manual_seed(7)
    affine = torch.eye(3).expand(B, T, 3, 3).contiguous()
    images = torch.from_numpy(images)
    trainer.make_train_step(cfg).loss_and_grads(
        state, images, torch.from_numpy(masks), torch.from_numpy(valid), gen,
        distill_images=images.clone(), distill_affine=affine)
    assert len(outs) == 2
    for key in ("pred_logits", "pred_masks"):
        assert torch.equal(outs[0][key], outs[1][key]), key
    again = own(images, generator=gen)
    assert not torch.equal(again["pred_masks"], outs[0]["pred_masks"])
