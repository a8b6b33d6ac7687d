"""The port's survivor readback as bbox crops, against the JAX package, on
the CPU: `postprocess_video`'s boxes, kept-first order and small bundle,
`start_kept_masks_read` / `finish_kept_masks_read` / `WindowMasks.paste`,
and `evaluate_dataset`'s two finalize threads, whose results.json must be
byte-identical to the whole-mask path's.

The mask logits are ellipses drawn at the stride-4 resolution (a few
tracks small, so that a window cuts most of the canvas and the crop path is
really taken), fed to both packages' postprocess directly; the end-to-end
test runs both evaluators with a stand-in model that returns each video's
ellipse logits (chosen by a pixel value the frames carry), so that its
masks are the ones under test and not a random network's. Masks, keep-sets
and RLEs must be identical to JAX's (the resize chain is the same f32
arithmetic on the same logits), scores within 1e-6.
"""
import json

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

from s2d_tpu.config import load_config as jax_load_config
from s2d_tpu.data import ytvis as jax_ytvis
from s2d_tpu.evaluation import evaluator as jax_evaluator
from s2d_tpu.evaluation import inference as jax_inference

from s2d_tpu_torch.config import from_s2d_config, load_config_tree
from s2d_tpu_torch.data import rle, ytvis
from s2d_tpu_torch.demo_video import VideoPredictor
from s2d_tpu_torch.evaluation import evaluator, inference

H, W = 96, 160  # network input = output size (no resize in the mapper)
H4, W4 = H // 4, W // 4
T = 5
KW = dict(num_classes=1, image_size=(H, W), output_size=(H, W))
# (cy, cx, ry, rx, vy, vx) at stride 4, or None for an empty mask
SMALL = [(8, 10, 3, 5, 0.5, 0.7), (8.3, 10.2, 3, 5, 0.5, 0.7),  # a duplicate NMS drops
         (21, 37, 2.5, 3, 0.2, 0.3),  # at the bottom-right edge: its window is clamped
         None, (15, 20, 4, 6, -0.5, 0.2), (5, 33, 2, 2, 0, 0)]
FULL = [(12, 20, 30, 50, 0, 0), (5, 5, 2, 2, 0, 0), (18, 30, 2, 3, 0, 0)]  # fills the frame


def ellipse_logits(specs, t=T, h4=H4, w4=W4):
    """(Q, t, h4, w4) f32 mask logits: 4 (1 - r^2) of each drifting ellipse,
    clipped to [-8, 8]; -4 everywhere for None. Scores fall with the index."""
    yy, xx = np.mgrid[:h4, :w4]
    masks = np.full((len(specs), t, h4, w4), -4.0, np.float32)
    for i, spec in enumerate(specs):
        if spec is not None:
            cy, cx, ry, rx, vy, vx = spec
            for ti in range(t):
                masks[i, ti] = 4 * (1 - ((yy - cy - vy * ti) / ry) ** 2
                                    - ((xx - cx - vx * ti) / rx) ** 2)
    q = len(specs)
    logits = np.stack([np.linspace(3.0, 0.5, q), np.zeros(q)], -1).astype(np.float32)
    return logits, np.clip(masks, -8, 8).astype(np.float32)


@pytest.fixture
def transport(monkeypatch):
    counts = {k: 0 for k in inference.TRANSPORT}
    monkeypatch.setattr(inference, "TRANSPORT", counts)
    return counts


def _both(specs):
    logits, masks = ellipse_logits(specs)
    q = len(specs)
    jp = jax_inference.postprocess_video(jnp.asarray(logits), jnp.asarray(masks), pack_bits=True,
                                         num_predictions=q, **KW)
    pp = inference.postprocess_video(torch.from_numpy(logits), torch.from_numpy(masks),
                                     num_predictions=q, **KW)
    return jp, pp


@pytest.mark.parametrize("case", ["small", "full"])
def test_postprocess_and_crop_readback_match_jax(case, transport):
    """The same survivors, boxes (pixels here, packed byte rows in JAX) and
    kept-first order; the crops pasted back equal JAX's survivors and the
    whole-mask read bit for bit. "small": the crop path, with a window
    clamped at the bottom and right edges (taller than the rows left below
    its box) and an empty survivor (box (0, 0, 1, 1), JAX's (0, 1) extent);
    "full": a frame-filling survivor sends the video the whole-row way."""
    jp, pp = _both(SMALL if case == "small" else FULL)
    js, jl, jk, jb = jax_inference.read_small_bundle(jp)
    ps, pl, pk, pb = inference.read_small_bundle(pp)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(ps, js, rtol=1e-6)
    np.testing.assert_array_equal(pp["order"].numpy(), np.asarray(jp["order"]))
    n = int(pk.sum())
    # kept-first, stable: the survivors in score order, then the rest
    assert list(pp["order"].numpy()[:n]) == list(np.flatnonzero(pk))
    # the masks themselves (restored to score order) equal JAX's bits
    full = np.unpackbits(np.asarray(jp["masks"]), axis=-2).view(bool)[..., :H, :]
    np.testing.assert_array_equal(pp["masks"].numpy(), full)
    # boxes: pixel rows here, the packed byte rows of JAX
    y0, x0, h, w = pb[:n].T
    np.testing.assert_array_equal(np.stack([y0 // 8, x0, (y0 + h + 7) // 8 - y0 // 8, w], -1),
                                  jb[:n])
    masks = pp["masks"].numpy()[:n]
    for i in range(n):
        ys, xs = np.nonzero(masks[i].any(0))
        want = (ys.min(), xs.min(), np.ptp(ys) + 1, np.ptp(xs) + 1) if ys.size else (0, 0, 1, 1)
        assert tuple(pb[i]) == want

    ref = jax_inference.finish_kept_masks_read(
        jax_inference.start_kept_masks_read(jp, jk, boxes=jb), jk)
    handle = inference.start_kept_masks_read(pp, pk, pb)
    moved = dict(transport)
    got = inference.finish_kept_masks_read(handle, as_window=True)
    whole = inference.finish_kept_masks_read(inference.start_kept_masks_read(pp, pk, None))
    if case == "small":
        assert isinstance(got, inference.WindowMasks)
        assert (moved["crop_tracks"], moved["row_tracks"]) == (n, 0)
        ch, cw = got.crops.shape[2:]
        assert ch * cw < 0.7 * H * W
        clamped = got.y0 < pb[:n, 0]
        assert clamped.any() and (got.y0[clamped] + ch == H).all()
        assert (got.x0 < pb[:n, 1]).any()
        assert tuple(pb[2]) == (0, 0, 1, 1) and not masks[2].any()
        got = got.paste()
    else:
        assert isinstance(got, np.ndarray) and (moved["crop_tracks"], moved["row_tracks"]) == (0, n)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(whole, ref)
    np.testing.assert_array_equal(inference.finalize_predictions(pp)["masks"], ref)


def test_zero_survivors_read_nothing(transport):
    """A keep-set with no survivor reads nothing back (either way) and
    gives no results.json entry."""
    _, pp = _both(SMALL)
    keep = np.zeros(len(SMALL), bool)
    _, _, _, boxes = inference.read_small_bundle(pp)
    for b in (boxes, None):
        got = inference.finish_kept_masks_read(inference.start_kept_masks_read(pp, keep, b))
        assert got.shape == (0, T, H, W)
        assert evaluator.predictions_to_results(
            1, {"scores": np.zeros(0), "labels": np.zeros(0, int), "masks": got}) == []
    assert transport["read_bytes"] == 0


def test_window_rles_equal_whole_mask_rles():
    """predictions_to_results encodes a WindowMasks straight from its
    windows: the same entries, byte for byte, as from the pasted masks."""
    _, pp = _both(SMALL)
    scores, labels, keep, boxes = inference.read_small_bundle(pp)
    win = inference.finish_kept_masks_read(inference.start_kept_masks_read(pp, keep, boxes),
                                           as_window=True)
    preds = {"scores": scores[keep], "labels": labels[keep]}
    a = evaluator.predictions_to_results(3, {**preds, "masks": win})
    b = evaluator.predictions_to_results(3, {**preds, "masks": win.paste()})
    assert json.dumps(a) == json.dumps(b)
    assert all(rle.decode(s).shape == (H, W) for r in a for s in r["segmentations"])


# ------------------------------------------------------------------ evaluate_dataset

LENGTHS = (5, 3, 8)  # one T-bucket (8): one stacked logits array serves every video
VIDEO_SPECS = [SMALL, SMALL[::-1], SMALL[2:] + SMALL[:2]]
TINY_OPTS = [
    "MODEL.MASK_FORMER.HIDDEN_DIM", "32", "MODEL.SEM_SEG_HEAD.MASK_DIM", "32",
    "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", str(len(SMALL)), "MODEL.MASK_FORMER.NHEADS", "4",
    "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "64", "MODEL.MASK_FORMER.DEC_LAYERS", "2",
    "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1",
    "MODEL.MASK_FORMER.TEST.NUM_PREDICTIONS", str(len(SMALL)),
    "INPUT.MIN_SIZE_TEST", str(H), "SOLVER.AMP.ENABLED", "False",
]


@pytest.fixture(scope="module")
def video_set(tmp_path_factory):
    """3 videos of PNG frames whose pixel (0, 0) is 20 x the video id, a
    ground-truth track per video (the first ellipse, binarized), and each
    video's (logits, mask logits) at the T-bucket's 8 frames."""
    root = tmp_path_factory.mktemp("crop_set")
    rng = np.random.RandomState(0)
    videos, annotations, frames, outputs = [], [], {}, []
    for vid, (t, specs) in enumerate(zip(LENGTHS, VIDEO_SPECS), start=1):
        files = [f"v{vid}/{i:05d}.png" for i in range(t)]
        (root / f"v{vid}").mkdir()
        frames[vid] = rng.randint(0, 256, (t, H, W, 3), np.uint8)
        frames[vid][:, 0, 0, :] = 20 * vid
        for name, f in zip(files, frames[vid]):
            cv2.imwrite(str(root / name), f[..., ::-1])
        logits, masks = ellipse_logits(specs, t=8)
        outputs.append((logits, masks))
        gt = jax_inference.postprocess_video(
            jnp.asarray(logits), jnp.asarray(masks[:, :t]), pack_bits=False,
            num_predictions=len(specs), **KW)["masks"][0]
        videos.append({"id": vid, "file_names": files, "height": H, "width": W, "length": t})
        annotations.append({"id": vid, "video_id": vid, "category_id": 1, "iscrowd": 0,
                            "segmentations": [rle.encode(np.asarray(m)) for m in gt]})
    path = root / "valid.json"
    path.write_text(json.dumps({"videos": videos, "annotations": annotations,
                                "categories": [{"id": 1, "name": "fg"}]}))
    for mod in (ytvis, jax_ytvis):
        mod.register_ytvis("tiny_torch_crops", str(path), str(root), class_agnostic=True)
    logits = np.stack([o[0] for o in outputs])[:, None]  # (V, 1, Q, 2)
    masks = np.stack([o[1] for o in outputs])[:, None]  # (V, 1, Q, 8, H4, W4)
    return frames, logits, masks


class _JaxStandIn:
    """model.apply for JAX's evaluator: each video's ellipse logits, picked
    by the pixel value its frames carry."""

    def __init__(self, logits, masks, mean, std):
        self.logits, self.masks = jnp.asarray(logits), jnp.asarray(masks)
        self.mean, self.std = mean[0], std[0]

    def apply(self, variables, images, frame_valid=None):
        vid = jnp.round((images[0, 0, 0, 0, 0] * self.std + self.mean) / 20).astype(jnp.int32)
        return {"pred_logits": self.logits[vid - 1], "pred_masks": self.masks[vid - 1]}


class _PortStandIn:
    """A `VideoPredictor` for `evaluate_dataset` whose forward returns each
    video's ellipse logits (picked as `_JaxStandIn` picks them); the
    predictor's own postprocess (the plain NMS loop on the CPU)."""

    postprocess = VideoPredictor.postprocess

    def __init__(self, cfg, logits, masks):
        self.cfg, self.device, self.kernels = cfg, torch.device("cpu"), False
        self.logits, self.masks = logits, masks

    def forward(self, frames_u8, frame_valid=None):
        vid = int(frames_u8[0, 0, 0, 0]) // 20
        return ({"pred_logits": torch.from_numpy(self.logits[vid - 1]),
                 "pred_masks": torch.from_numpy(self.masks[vid - 1])}, (H, W))


def test_evaluate_dataset_crops_match_whole_rows_and_jax(video_set, tmp_path, transport):
    """results.json of the crop path byte-identical to the whole-row
    path's (survivors in the same, score order) and equal to JAX's
    evaluator's (same entries, RLEs identical, scores within 1e-6; the
    same AP); the crop path was taken for every survivor."""
    frames, logits, masks = video_set
    cfg = jax_load_config(None, opts=TINY_OPTS)
    stand_in = _JaxStandIn(logits, masks, cfg.model.pixel_mean, cfg.model.pixel_std)
    ref = jax_evaluator.evaluate_dataset(cfg, stand_in, {}, "tiny_torch_crops",
                                         output_dir=str(tmp_path / "jax"))

    predictor = _PortStandIn(from_s2d_config(load_config_tree(None, TINY_OPTS)), logits, masks)
    mapper = lambda record: {"image": frames[record["video_id"]]}  # noqa: E731
    got = {}
    for crop in (True, False):
        before = dict(transport)
        got[crop] = evaluator.evaluate_dataset(predictor, "tiny_torch_crops", mapper=mapper,
                                               output_dir=str(tmp_path / str(crop)),
                                               crop_masks=crop)
        moved = {k: transport[k] - before[k] for k in transport}
        kind = "crop_tracks" if crop else "row_tracks"
        assert moved[kind] > 0 and moved["crop_tracks" if not crop else "row_tracks"] == 0
        if crop:
            assert moved["read_bytes"] < 0.5 * moved["canvas_bytes"]
    text = {c: (tmp_path / str(c) / "results.json").read_bytes() for c in (True, False)}
    assert text[True] == text[False]
    results = json.loads(text[True])
    ref_results = json.loads((tmp_path / "jax" / "results.json").read_text())
    assert results and len(results) == len(ref_results)
    for r, e in zip(results, ref_results):
        assert (r["video_id"], r["category_id"]) == (e["video_id"], e["category_id"])
        assert r["segmentations"] == e["segmentations"]
        np.testing.assert_allclose(r["score"], e["score"], rtol=1e-6)
    for vid in (1, 2, 3):
        scores = [r["score"] for r in results if r["video_id"] == vid]
        assert scores == sorted(scores, reverse=True)
    assert ref["AP"] > 0.3
    for key in ("AP", "AP50", "AP75", "AR1", "AR10"):
        assert got[True][key] == got[False][key]
        np.testing.assert_allclose(got[True][key], ref[key], atol=1e-9)
    assert list(got[True]) == list(ref)
