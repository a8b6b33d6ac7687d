"""The port's CutLER detector (stage 1) against the JAX package, module by
module, all f32 on the CPU, at a small size: image 64, 16 proposals,
pre-NMS top-k 64, 4 instances.

One JAX init and forward is shared (module fixtures). The port gets the same
weights through `params_from_jax` and, where a hard decision (a top-k, an
NMS, the cascade's IoU matching) would flip on rounding, JAX's own
proposals through `proposals=`. Tolerances: boxes, IoUs and deltas rtol
1e-5 (the same f32 formulas); network outputs and losses rtol 1e-3 / atol
2e-3 (convs and matmuls reduce in other orders); ROIAlign atol 1e-5 and its
gradients atol 1e-4; keep-sets identical.
"""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import jax
import jax.numpy as jnp

from s2d_tpu.models import cutler as jc
from s2d_tpu.ops import boxes as jb
from s2d_tpu.ops import roi_align as jr
from s2d_tpu.train import cutler_trainer as jt
from s2d_tpu.evaluation import tta_rcnn as jtta

from s2d_tpu_torch.checkpoint import from_jax
from s2d_tpu_torch.models import cutler as pc
from s2d_tpu_torch.ops import boxes as pb
from s2d_tpu_torch.ops import roi_align as pr
from s2d_tpu_torch.train import cutler_trainer as pt
from s2d_tpu_torch.evaluation import tta_rcnn as ptta

REPO = os.path.join(os.path.dirname(__file__), "..")
SIZE = 64
RTOL, ATOL = 1e-3, 2e-3
JCFG = jc.CutlerConfig(num_proposals=16, pre_nms_topk=64)
PCFG = pc.CutlerConfig(num_proposals=16, pre_nms_topk=64)


def _np(x):
    return np.array(x, dtype=np.float32) if np.asarray(x).dtype.kind == "f" else np.array(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got.detach() if isinstance(got, torch.Tensor) else got),
                               _np(ref), rtol=rtol, atol=atol, err_msg=what)


def _random_boxes(rng, n, size=SIZE, min_wh=2.0):
    xy = rng.rand(n, 2) * size * 0.8
    wh = min_wh + rng.rand(n, 2) * size * 0.5
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _flat(variables):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread, beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(0).randn(1, SIZE, SIZE, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_model():
    """JAX's model with weights made by the port (torch's init, converted by
    `params_to_jax`: flax's own init of the R50 takes 15-35 s here), the
    biases randomised, so a bias transposed or dropped shows, and the delta
    heads scaled down, so that proposals and refined boxes stay near their
    anchors inside the image (unscaled most leave it and clip to zero
    area)."""
    torch.manual_seed(0)
    flat = from_jax.params_to_jax(pc.CutlerRCNN(PCFG).state_dict())
    rng = np.random.RandomState(1)
    for k in sorted(flat):
        if k.endswith("/bias"):
            flat[k] = flat[k] + 0.05 * rng.randn(*flat[k].shape).astype(np.float32)
        if k.endswith("/deltas/kernel"):
            flat[k] = flat[k] * 0.01
        if k.endswith("/box/kernel"):
            flat[k] = flat[k] * 0.1
    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return jc.CutlerRCNN(cfg=JCFG), params


@pytest.fixture(scope="module")
def port_model(jax_model):
    model = pc.CutlerRCNN(PCFG)
    from_jax.load_params_from_jax(model, _flat(jax_model[1]))
    return model


@pytest.fixture(scope="module")
def jax_out(jax_model, image):
    model, params = jax_model
    return jax.tree_util.tree_map(np.asarray, jax.jit(model.apply)(params, jnp.asarray(image)))


# ---------------------------------------------------------------- box ops


def test_box_ops_match_jax():
    rng = np.random.RandomState(2)
    a, b = _random_boxes(rng, 12), _random_boxes(rng, 9)
    a[3] = [5, 5, 5, 9]  # zero area
    _close(pb.pairwise_iou(_t(a), _t(b)), jb.pairwise_iou(a, b), 1e-5, 1e-7)
    _close(pb.box_area(_t(a)), jb.box_area(a), 1e-5, 1e-6)
    deltas = (rng.randn(12, 4) * 2).astype(np.float32)
    deltas[0, 2:] = 9.0  # past SCALE_CLAMP
    _close(pb.decode_deltas(_t(a), _t(deltas)), jb.decode_deltas(a, deltas), 1e-5, 1e-4)
    _close(pb.encode_deltas(_t(a), _t(a[::-1].copy())), jb.encode_deltas(a, a[::-1]), 1e-5, 1e-5)
    wide = (a * 1.6 - 10).astype(np.float32)
    _close(pb.clip_boxes(_t(wide), (40, 50)), jb.clip_boxes(wide, (40, 50)), 1e-5, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_nms_keep_sets_match_jax(seed):
    """Score ties (the stable sort's order decides which suppresses which)
    and -inf entries included: keep masks identical."""
    rng = np.random.RandomState(seed)
    boxes = _random_boxes(rng, 40)
    boxes[10:20] = boxes[0:10] + rng.rand(10, 4).astype(np.float32) * 3  # overlapping pairs
    scores = np.round(rng.rand(40), 1).astype(np.float32)  # many ties
    scores[rng.rand(40) < 0.2] = -np.inf
    for thresh in (0.3, 0.5, 0.7):
        got = pb.box_nms(_t(boxes), _t(scores), thresh).numpy()
        ref = np.asarray(jb.box_nms(jnp.asarray(boxes), jnp.asarray(scores), thresh))
        np.testing.assert_array_equal(got, ref)


def test_top_k_tie_order_is_lax_top_k():
    """lax.top_k returns ties lowest index first; so must the port (the
    -inf of suppressed proposals tie by the hundred)."""
    x = np.array([1.0, -np.inf, 3.0, 3.0, -np.inf, 1.0, -np.inf, 0.5], np.float32)
    vals, idx = pb.top_k_stable(_t(x), 7)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


def test_select_proposals_minus_inf_order():
    """Fewer than num_proposals survive the NMS: the -inf entries still
    become proposals, in lax.top_k's order (boxes identical to JAX's)."""
    rng = np.random.RandomState(3)
    anchors = np.repeat(_random_boxes(rng, 6), 8, axis=0)  # 48 anchors, 6 distinct
    logits = np.round(rng.randn(48), 1).astype(np.float32)
    deltas = (rng.randn(48, 4) * 0.02).astype(np.float32)  # near-duplicates: most suppressed
    got_b, got_s = pc.select_proposals(_t(anchors), _t(logits), _t(deltas), (SIZE, SIZE),
                                       32, 0.7, 20)
    ref_b, ref_s = jc.select_proposals(jnp.asarray(anchors), jnp.asarray(logits),
                                       jnp.asarray(deltas), (SIZE, SIZE), 32, 0.7, 20)
    assert np.isinf(np.asarray(ref_s)).sum() >= 10
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    _close(got_b, ref_b, 1e-5, 1e-5)


# ---------------------------------------------------------------- ROIAlign


def test_roi_align_and_gradients_match_jax():
    rng = np.random.RandomState(4)
    feats = {f"p{i + 2}": rng.randn(SIZE // 2 ** (i + 2), SIZE // 2 ** (i + 2), 8).astype(np.float32)
             for i in range(4)}
    boxes = _random_boxes(rng, 10, min_wh=4.0)
    boxes[0] = [-3, -2, 70, 66]  # past the borders
    boxes[1] = [2, 2, 60, 60]  # a large box: level 3+
    w = rng.randn(10, 7, 7, 8).astype(np.float32)

    got = pr.roi_align(_t(feats["p2"]), _t(boxes / 4), 7, 2)
    _close(got, jr.roi_align(jnp.asarray(feats["p2"]), jnp.asarray(boxes / 4), 7, 2), 0, 1e-5)

    np.testing.assert_array_equal(pr.assign_boxes_to_levels(_t(boxes)).numpy(),
                                  np.asarray(jr.assign_boxes_to_levels(jnp.asarray(boxes))))

    def jax_loss(f, b):
        return (jr.multilevel_roi_align(f, b, 7, 2) * w).sum()

    ref = jax.jit(jr.multilevel_roi_align, static_argnums=(2, 3))(
        {k: jnp.asarray(v) for k, v in feats.items()}, boxes, 7, 2)
    jgf, jgb = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(boxes))
    tf = {k: _t(v).requires_grad_() for k, v in feats.items()}
    tb = _t(boxes).requires_grad_()
    out = pr.multilevel_roi_align(tf, tb, 7, 2)
    _close(out, ref, 0, 1e-5)
    (out * _t(w)).sum().backward()
    for k in feats:
        _close(tf[k].grad, jgf[k], 0, 1e-4, what=k)
    _close(tb.grad, jgb, 1e-4, 1e-4, what="boxes")


# ---------------------------------------------------------------- modules


def test_fpn_upsample_is_nearest_exact():
    """At a size that is not a multiple of 32 the levels are not 2x apart
    (72: 18, 9, 5, 3), where torch's "nearest" and JAX's half-pixel nearest
    differ: the port's FPN matches JAX's."""
    rng = np.random.RandomState(5)
    shapes = {"res2": (18, 256), "res3": (9, 512), "res4": (5, 1024), "res5": (3, 2048)}
    feats = {k: rng.randn(1, s, s, c).astype(np.float32) for k, (s, c) in shapes.items()}
    fpn = jc.FPN()
    variables = fpn.init(jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in feats.items()})
    ref = fpn.apply(variables, {k: jnp.asarray(v) for k, v in feats.items()})
    port = pc.FPN()
    from_jax.load_params_from_jax(port, _flat(variables))
    got = port({k: _t(v).permute(0, 3, 1, 2) for k, v in feats.items()})
    for name in pc.FPN_LEVELS:
        _close(got[name].permute(0, 2, 3, 1), ref[name], what=name)


def test_generate_anchors_match_jax():
    shapes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    for a, b in zip(pc.generate_anchors(shapes), jc.generate_anchors(shapes)):
        np.testing.assert_array_equal(a, b)


def test_model_matches_jax_with_its_proposals(jax_model, port_model, jax_out, image):
    """Objectness, RPN deltas, each stage's scores, deltas and boxes, the
    final boxes and the mask logits, with JAX's proposals fed in; the mask
    head at given boxes (`mask_boxes=`, and `mask_logits_at`, the TTA's
    mask pass)."""
    with torch.no_grad():
        out = port_model(_t(image), proposals=_t(jax_out["proposals"]))
    _close(out["anchors"], jax_out["anchors"], 0, 0)
    _close(out["objectness"], jax_out["objectness"], what="objectness")
    _close(out["rpn_deltas"], jax_out["rpn_deltas"], what="rpn_deltas")
    for si, (ps, js) in enumerate(zip(out["stages"], jax_out["stages"])):
        for key in ("scores", "deltas", "boxes"):
            _close(ps[key], js[key], what=f"stage{si} {key}")
    _close(out["final_boxes"], jax_out["final_boxes"], what="final_boxes")
    _close(out["mask_logits"], jax_out["mask_logits"], what="mask_logits")
    # the TTA's mask pass: the mask head at given boxes (mask_boxes=; at the
    # final boxes, JAX's own mask logits)
    with torch.no_grad():
        given = port_model(_t(image), proposals=_t(jax_out["proposals"]),
                           mask_boxes=_t(jax_out["final_boxes"][::-1].copy()))
    _close(given["mask_logits"], jax_out["mask_logits"][::-1], what="mask_boxes=")
    # the CLI's TTA mask pass: the mask head alone at those boxes
    with torch.no_grad():
        alone = port_model.mask_logits_at(_t(image), _t(jax_out["final_boxes"][::-1].copy()))
    _close(alone, jax_out["mask_logits"][::-1], what="mask_logits_at")


def test_model_selects_jax_proposals(port_model, jax_out, image):
    """The whole forward, proposals selected inside: this seeded image keeps
    the objectness scores apart, so the proposal set is JAX's."""
    k = JCFG.pre_nms_topk
    with torch.no_grad():
        out = port_model(_t(image))
    # the top-k's members and order, the NMS's visiting order, are JAX's
    ref_order = np.argsort(-jax_out["objectness"], kind="stable")[:k]
    np.testing.assert_array_equal(
        np.argsort(-out["objectness"].numpy(), kind="stable")[:k], ref_order)
    logits = np.sort(jax_out["objectness"])[::-1]
    assert logits[k - 1] - logits[k] > 1e-4  # the top-k's edge is apart
    _close(out["proposals"], jax_out["proposals"], 1e-5, 1e-4, what="proposals")


def test_deconv_layout_needs_the_flip(jax_model, jax_out, image, monkeypatch):
    """flax's ConvTranspose kernel loaded by the generic HWIO -> OIHW rule
    (same shapes: 256 in, 256 out) gives wrong mask logits; the
    CONV_TRANSPOSE rule (flipped, IOHW) gives JAX's, and round-trips."""
    flat = _flat(jax_model[1])
    monkeypatch.setattr(from_jax, "CONV_TRANSPOSE", ())
    wrong = pc.CutlerRCNN(PCFG)
    from_jax.load_params_from_jax(wrong, flat)
    monkeypatch.undo()
    right = pc.CutlerRCNN(PCFG)
    from_jax.load_params_from_jax(right, flat)
    proposals = _t(jax_out["proposals"])
    with torch.no_grad():
        bad = wrong(_t(image), proposals=proposals)["mask_logits"].numpy()
        good = right(_t(image), proposals=proposals)["mask_logits"].numpy()
    _close(good, jax_out["mask_logits"])
    assert not np.allclose(bad, jax_out["mask_logits"], rtol=RTOL, atol=ATOL)
    back = from_jax.params_to_jax(right.state_dict())
    np.testing.assert_array_equal(back["params/mask_head/deconv/kernel"],
                                  flat["params/mask_head/deconv/kernel"])


# ---------------------------------------------------------------- losses


def _gt(rng, n_valid=3, g=4):
    boxes = np.zeros((g, 4), np.float32)
    boxes[:n_valid] = _random_boxes(rng, n_valid, min_wh=12.0)
    boxes[:, 2:] = np.minimum(boxes[:, 2:], SIZE)
    masks = np.zeros((g, SIZE, SIZE), bool)
    for i in range(n_valid):
        x0, y0, x1, y1 = boxes[i].astype(int)
        masks[i, y0:y1, x0:x1] = True
    valid = np.arange(g) < n_valid
    labels = np.zeros(g, np.int32)
    return boxes, labels, valid, masks


def _port_out(jax_out):
    """JAX's output dict as tensors: the loss functions on identical inputs."""
    return jax.tree_util.tree_map(lambda v: _t(v) if v is not None else None, jax_out)


@pytest.mark.parametrize("droploss", [0.01, -1.0])
def test_losses_match_jax(jax_out, droploss):
    rng = np.random.RandomState(6)
    boxes, labels, valid, masks = _gt(rng)
    fb = jax_out["final_boxes"]
    boxes[0] = fb[np.argmax((fb[:, 2] - fb[:, 0]) * (fb[:, 3] - fb[:, 1]))]  # a fg mask loss
    assert (boxes[0, 2:] - boxes[0, :2]).min() > 4
    masks[0] = 0
    x0, y0, x1, y1 = np.round(boxes[0]).astype(int)
    masks[0, y0:y1, x0:x1] = True
    jcfg = dataclasses.replace(JCFG, droploss_iou_thresh=droploss)
    pcfg = dataclasses.replace(PCFG, droploss_iou_thresh=droploss)
    out = _port_out(jax_out)
    got = {**pc.rpn_losses(out, _t(boxes), _t(valid)),
           **pc.roi_losses(out, _t(boxes), _t(labels), _t(valid), pcfg),
           **pc.mask_loss(out, _t(masks), _t(boxes), _t(valid), pcfg)}
    ref = jax.jit(lambda o, b, l, v, m: {**jc.rpn_losses(o, b, v), **jc.roi_losses(o, b, l, v, jcfg),
                                         **jc.mask_loss(o, m, b, v, jcfg)})(
        jax_out, boxes, labels, valid, masks)
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k], ref[k], what=k)
    assert float(ref["loss_mask"]) > 0


# ---------------------------------------------------------------- train step


class _WithProposals:
    """JAX's model with fixed proposals, for make_cutler_train_step."""

    def __init__(self, model, proposals):
        self.model, self.proposals = model, proposals

    def apply(self, params, image):
        return self.model.apply(params, image, proposals=self.proposals)


def test_train_step_matches_jax(jax_model, jax_out, image):
    """Two micro-steps of accumulation (one optimizer step) at warmup's first
    step, per-param norm clip, a multiplier on the mask head and the box
    stage 1 (`BASE_LR_MULTIPLIER_NAMES` match flax paths), from the same
    weights and JAX's proposals: losses, then every updated parameter at
    atol 1e-5, and its update within 1% of the update's own size (max |p1 -
    p0|; the gradients agree to ~1e-3, f32 sums in other orders) plus two
    ulps of the parameter."""
    model, params = jax_model
    tcfg = dict(base_lr=0.02, momentum=0.9, weight_decay=1e-4, warmup_iters=10,
                warmup_factor=0.1, steps=(100,), clip_value=0.5, clip_type="norm",
                accum_steps=2, base_lr_multiplier=3.0,
                base_lr_multiplier_names=("mask_head", "box_stage1.fc2"))
    jcfg = jt.CutlerTrainerConfig(rcnn=JCFG, **tcfg)
    pcfg = pt.CutlerTrainerConfig(rcnn=PCFG, **tcfg)
    rng = np.random.RandomState(7)
    samples = [_gt(rng) for _ in range(2)]
    images_u8 = [np.random.RandomState(8 + i).randint(0, 256, (1, SIZE, SIZE, 3)).astype(np.uint8)
                 for i in range(2)]
    mean, std = np.asarray(jcfg.pixel_mean, np.float32), np.asarray(jcfg.pixel_std, np.float32)

    tx = jt.build_cutler_optimizer(params, jcfg)
    opt_state = tx.init(params)
    step = jax.jit(jt.make_cutler_train_step(
        _WithProposals(model, jnp.asarray(jax_out["proposals"])), jcfg, tx))
    jparams = params
    jmetrics = []
    for img, (b, l, v, m) in zip(images_u8, samples):
        jparams, opt_state, met = step(jparams, opt_state, (img.astype(np.float32) - mean) / std,
                                       b, l, v, m)
        jmetrics.append(jax.tree_util.tree_map(float, met))

    port = pc.CutlerRCNN(PCFG)
    from_jax.load_params_from_jax(port, _flat(params))
    opt = pt.build_cutler_optimizer(port, pcfg)
    proposals = _t(jax_out["proposals"])

    def with_proposals(img):
        return pc.CutlerRCNN.forward(port, img, proposals=proposals)

    step_fn = pt.make_cutler_train_step(with_proposals, pcfg, opt)
    for i, (img, (b, l, v, m)) in enumerate(zip(images_u8, samples)):
        met = step_fn(_t(img), _t(b), _t(l), _t(v), _t(m))
        for k, ref in jmetrics[i].items():
            _close(met[k], ref, what=f"micro-step {i} {k}")
    assert opt.count == 1 and opt.mini_step == 0

    got = from_jax.params_to_jax(port.state_dict())
    before, after = _flat(params), _flat(jparams)
    assert set(got) == set(after)
    mults = 0
    for k, ref in after.items():
        np.testing.assert_allclose(got[k], ref, rtol=0, atol=1e-5, err_msg=k)
        moved = np.abs(ref - before[k]).max()
        err = np.abs((got[k] - before[k]) - (ref - before[k])).max()
        assert err <= 1e-2 * moved + 2 * np.spacing(np.abs(ref).max()), (k, err, moved)
        mults += "mask_head" in k or "box_stage1/fc2" in k
    assert mults == 14  # 6 mask head layers and fc2, a kernel and a bias each
    assert np.abs(after["params/backbone/stem_norm1/scale"]
                  - before["params/backbone/stem_norm1/scale"]).max() > 0  # FrozenBN trained


def test_optimizer_clip_types_match_optax():
    """clip "value" and "full_model" and the schedule past warmup and a
    milestone, on the same gradients: optax's updates."""
    rng = np.random.RandomState(9)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 3).astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    for clip_type in ("value", "full_model", "norm"):
        kw = dict(base_lr=0.1, momentum=0.9, weight_decay=1e-3, warmup_iters=2,
                  warmup_factor=0.5, steps=(3,), clip_value=1.5, clip_type=clip_type)
        tx = jt.build_cutler_optimizer(params, jt.CutlerTrainerConfig(**kw))
        state = tx.init(params)
        jp = params
        for g in grads:
            up, state = tx.update(g, state, jp)
            jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, up)
        tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
        opt = pt.CutlerOptimizer(list(tp.items()), pt.CutlerTrainerConfig(**kw))
        for g in grads:
            opt.step([_t(g[k]) for k in tp])
        for k in tp:
            _close(tp[k], jp[k], 1e-6, 1e-6, what=f"{clip_type} {k}")


def test_load_cutler_yaml_matches_jax():
    files = sorted(glob.glob(os.path.join(REPO, "configs", "cutler", "**", "*.yaml"),
                             recursive=True)
                   + glob.glob(os.path.join(REPO, "configs", "cuts3d", "*.yaml")))
    assert len(files) >= 17
    for f in files:
        assert pt.load_cutler_yaml(f) == jt.load_cutler_yaml(f), f


# ---------------------------------------------------------------- inference


def _stage_scores(rng, r, ties=True):
    logits = rng.randn(r, 2).astype(np.float32)
    if ties:
        logits[5:9] = logits[0]  # equal scores on distinct boxes
    return logits


def test_cascade_detections_match_jax():
    rng = np.random.RandomState(10)
    r = 24
    boxes = _random_boxes(rng, r)
    boxes[12:16] = boxes[0:4] + 0.5
    stages = [{"scores": _stage_scores(rng, r)} for _ in range(3)]
    masks = rng.randn(r, 28, 28).astype(np.float32)
    jout = {"stages": stages, "final_boxes": boxes, "mask_logits": masks}
    for thresh, topk in ((0.3, 10), (0.05, 30)):
        ref = jt.cascade_detections(jout, 1, thresh, 0.5, topk, with_masks=True)
        got = pt.cascade_detections(_port_out(jout), 1, thresh, 0.5, topk, with_masks=True)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        for g, r_ in zip(got[:2] + got[4:], ref[:2] + ref[4:]):
            _close(g, r_, 1e-3, 1e-6)


def test_merge_detections_match_jax():
    rng = np.random.RandomState(11)
    n = 60
    boxes = (_random_boxes(rng, n) - 10).astype(np.float32)  # negative coordinates too
    scores = np.round(rng.rand(n), 2).astype(np.float32)
    classes = rng.randint(0, 3, n).astype(np.int32)
    valid = rng.rand(n) < 0.8
    ref = jtta.merge_detections(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                                jnp.asarray(valid), nms_thresh=0.5, topk=20)
    got = ptta.merge_detections(_t(boxes), _t(scores), _t(classes), _t(valid),
                                nms_thresh=0.5, topk=20)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    _close(got[0], ref[0], 1e-3, 1e-5)
    _close(got[1], ref[1], 1e-3, 1e-6)


def test_tta_inference_matches_jax():
    """The whole sweep from the same per-augmentation detections and mask
    probabilities (stand-in infer functions, a fixed draw a call): merged
    keep-set, boxes, scores and averaged, flipped-back masks."""
    rng = np.random.RandomState(12)
    img = rng.rand(40, 56, 3).astype(np.float32) * 255
    min_sizes = (32, 48)
    n_aug = 2 * len(min_sizes)
    dets = []
    for a in range(n_aug):
        b = _random_boxes(rng, 10, size=96)
        dets.append((b, np.round(rng.rand(10), 2).astype(np.float32),
                     np.zeros(10, np.int32), rng.rand(10) < 0.9))
    probs = [rng.rand(10, 28, 28).astype(np.float32) for _ in range(n_aug)]

    def stand_ins(to_array):
        calls = {"boxes": 0, "masks": 0}

        def infer_boxes(*args):
            d = dets[calls["boxes"]]
            calls["boxes"] += 1
            return tuple(to_array(x) for x in d)

        def infer_masks(*args):
            p = probs[calls["masks"]]
            calls["masks"] += 1
            return p

        return infer_boxes, infer_masks

    kw = dict(min_sizes=min_sizes, max_size=4000, flip=True, pixel_mean=(1, 2, 3),
              pixel_std=(4, 5, 6), nms_thresh=0.5, topk=12)
    jb_, jm_ = stand_ins(jnp.asarray)
    ref = jtta.tta_inference(None, img, infer_boxes=lambda p, c: jb_(), infer_masks=lambda p, c, b: jm_(), **kw)
    pb_, pm_ = stand_ins(_t)
    got = ptta.tta_inference(img, infer_boxes=lambda c: pb_(), infer_masks=lambda c, b: pm_(), **kw)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    _close(got[0], ref[0], 1e-3, 1e-4)
    _close(got[1], ref[1], 1e-3, 1e-6)
    _close(got[4], ref[4], 1e-5, 1e-6)
    # the canvases themselves: the port's f32 resize is within 1e-3 of cv2's
    gc, gm = ptta.tta_variants(img, min_sizes, 4000, True, (1, 2, 3), (4, 5, 6))
    rc, rm = jtta.tta_variants(img, min_sizes, 4000, True, (1, 2, 3), (4, 5, 6))
    assert gm == rm
    _close(gc * np.asarray((4, 5, 6), np.float32), rc * np.asarray((4, 5, 6), np.float32), 0, 1e-3)


def test_paste_masks_match_jax():
    """>= 99.9% of pixels agree: the f32 resize is within 1e-3 of cv2's, not
    bit-exact at the 0.5 threshold."""
    rng = np.random.RandomState(13)
    masks = rng.rand(8, 28, 28).astype(np.float32)
    boxes = _random_boxes(rng, 8, size=120) - 10  # partly outside the canvas
    got = pt.paste_masks(masks, boxes, (100, 130))
    ref = jt.paste_masks(masks, boxes, (100, 130))
    assert got.shape == ref.shape and (got == ref).mean() >= 0.999
