"""The port's CutLER CLI (`python -m s2d_tpu_torch.train_net`) and its data
path against the JAX package, on the CPU, on a synthetic COCO-format set:
3 PNG images of 48x64 with 2 RLE ellipses each, at image size 64, 16
proposals, 4 instances.

Train (--max-iter 1 with LR multipliers and --copy-paste), --resume to 2
with --no-segm (its eval prints no mask AP), --eval-only with --tta. The eval's detections are
held to JAX's `infer` and `finalize` (tools/train_net.py:224-266) and its
TTA pass's boxes to `tta_inference` on the same weights: keep-sets identical, boxes
and scores rtol 1e-3, segmentation pixels >= 99.9% (the f32 mask resize is
within 1e-3 of cv2's, not bit-exact at the 0.5 threshold). The mapper, the
image copy-paste and the COCO loader are held to JAX's exactly (the uint8
resize is cv2's bit for bit), and stage 1 runs with JAX, cv2 and PIL hidden.
"""
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

import jax
import jax.numpy as jnp

from s2d_tpu.data import coco as jcoco
from s2d_tpu.data import copy_paste as jcp
from s2d_tpu.data import rle as jrle
from s2d_tpu.evaluation import tta_rcnn as jtta
from s2d_tpu.models import cutler as jc
from s2d_tpu.train import cutler_trainer as jt

from s2d_tpu_torch import train_net
from s2d_tpu_torch.checkpoint import from_jax
from s2d_tpu_torch.checkpoint.io import save_checkpoint
from s2d_tpu_torch.data import coco as pcoco
from s2d_tpu_torch.data import copy_paste as pcp
from s2d_tpu_torch.data import rle as prle
from s2d_tpu_torch.data.png import read_png, write_png
from s2d_tpu_torch.evaluation import ytvos_eval
from s2d_tpu_torch.models import cutler as pc
from s2d_tpu_torch.train import cutler_trainer as pt

REPO = os.path.join(os.path.dirname(__file__), "..")
H, W = 48, 64
SMALL = ["--image-size", "64", "--max-instances", "4", "--num-proposals", "16",
         "--device", "cpu"]
TTA_SIZES = ("32",)  # a canvas of 64, 2 augmentations: JAX's one compile serves both passes


@pytest.fixture(scope="module", autouse=True)
def _one_thread_no_tensorboard():
    """torch on one thread, beside the suite's other workers, and without the
    metric log's optional tensorboard sink (its import pulls in TensorFlow,
    ~12 s), as tests/test_torch_train_cli.py runs the video CLI."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(threads)


def _write_set(root, n=3, seed=0):
    rng = np.random.RandomState(seed)
    (root / "imgs").mkdir(parents=True)
    images, anns = [], []
    yy, xx = np.mgrid[:H, :W]
    for i in range(n):
        img = (rng.rand(H, W, 3) * 60).astype(np.uint8)
        for _ in range(2):
            cy, cx = rng.randint(H // 4, 3 * H // 4), rng.randint(W // 4, 3 * W // 4)
            ry, rx = rng.randint(6, H // 3), rng.randint(6, W // 3)
            m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
            img[m] = rng.randint(120, 255, 3)
            ys, xs = np.nonzero(m)
            seg = prle.encode(m)
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": 1,
                         "bbox": [float(xs.min()), float(ys.min()),
                                  float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)],
                         "area": int(m.sum()), "iscrowd": 0,
                         "segmentation": {"size": list(seg["size"]), "counts": seg["counts"]}})
        write_png(str(root / "imgs" / f"{i}.png"), img)
        images.append({"id": i + 1, "file_name": f"{i}.png", "height": H, "width": W})
    (root / "train.json").write_text(json.dumps(
        {"images": images, "annotations": anns, "categories": [{"id": 1, "name": "fg"}]}))
    return str(root / "train.json"), str(root / "imgs")


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    json_path, img_dir = _write_set(tmp_path_factory.mktemp("cutler_coco"))
    pcoco.register_coco("cutler_cli_syn", json_path, img_dir, class_agnostic=True)
    return json_path, img_dir


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_net.main(argv) == 0
    return buf.getvalue()


# ---------------------------------------------------------------- data path


def test_coco_loader_matches_jax(coco_set):
    json_path, img_dir = coco_set
    for agnostic in (True, False):
        assert pcoco.load_coco_json(json_path, img_dir, agnostic) == \
            jcoco.load_coco_json(json_path, img_dir, agnostic)


def test_mapper_and_copy_paste_match_jax(coco_set):
    """map_image_record (train: resize, flip draw; eval) and copy_paste_image
    from the same draws: identical canvases, targets and draws."""
    dicts, _ = pcoco.load_coco_json(*coco_set, True)
    cfg_kw = dict(image_size=64, min_size_train=56, max_instances=4)
    pcfg, jcfg = pt.CutlerTrainerConfig(**cfg_kw), jt.CutlerTrainerConfig(**cfg_kw)
    for is_train in (True, False):
        prng, jrng = np.random.RandomState(3), np.random.RandomState(3)
        got = [pt.map_image_record(r, pcfg, prng, is_train, normalize=False) for r in dicts * 2]
        ref = [jt.map_image_record(r, jcfg, jrng, is_train, normalize=False) for r in dicts * 2]
        for g, r in zip(got, ref):
            assert g.keys() == r.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        assert prng.rand() == jrng.rand()
    prng, jrng = np.random.RandomState(5), np.random.RandomState(5)
    for dst, src in zip(got[:4], got[1:5]):
        g = pcp.copy_paste_image(prng, dst, src, min_ratio=0.5, max_ratio=1.0)
        r = jcp.copy_paste_image(jrng, dst, src, min_ratio=0.5, max_ratio=1.0)
        for k in g:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    assert prng.rand() == jrng.rand()


# two overlapping parts, one leaving the image, one with a .5 to round to even
POLYS = [[2.0, 3.0, 30.5, 4.0, 11.0, 37.9, -6.0, 20.0], [20.0, 10.0, 70.0, 12.5, 40.0, 39.0]]


def test_stage1_runs_without_jax_cv2_or_pil(coco_set, tmp_path):
    """With jax, flax, yaml, s2d_tpu, cv2 and PIL blocked on import (the
    card's machine has none of them): stage 1's modules and chip_smoke
    import, a PNG is read by data/png.py and a JPEG by data/jpeg.py (the
    pixels of cv2's reads), polygons are filled as cv2.fillPoly fills them,
    and the train mapper maps an image of the PNG set with its RLE masks."""
    import cv2

    png = os.path.join(coco_set[1], "0.png")
    cv2.imwrite(str(tmp_path / "frame.jpg"),
                np.random.RandomState(1).randint(0, 256, (30, 44, 3), np.uint8))
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2', 'PIL', 'yaml', 's2d_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "import s2d_tpu_torch.models.cutler, s2d_tpu_torch.ops.boxes, s2d_tpu_torch.ops.roi_align\n"
        "import s2d_tpu_torch.train.cutler_trainer, s2d_tpu_torch.evaluation.tta_rcnn, chip_smoke\n"
        "from s2d_tpu_torch import train_net\n"
        "from s2d_tpu_torch.data import coco, mapper\n"
        f"img = mapper.load_image_robust({png!r})\n"
        f"np.save({str(tmp_path / 'img.npy')!r}, img)\n"
        f"jpg = mapper.load_image_robust({str(tmp_path / 'frame.jpg')!r})\n"
        f"np.save({str(tmp_path / 'jpg.npy')!r}, jpg)\n"
        "from s2d_tpu_torch.data import rle\n"
        f"np.save({str(tmp_path / 'poly.npy')!r}, rle.polygons_to_mask({POLYS!r}, 40, 56))\n"
        f"coco.register_coco('blocked', {coco_set[0]!r}, {coco_set[1]!r}, True)\n"
        "cfg = train_net.build_config(train_net.parse_args(['--image-size', '64']))[0]\n"
        "sample = s2d_tpu_torch.train.cutler_trainer.map_image_record(\n"
        "    coco.get_coco_dataset('blocked')[0][0], cfg, is_train=True, normalize=False)\n"
        "assert sample['image'].dtype == np.uint8 and sample['valid'].sum() == 2\n"
    )
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = cv2.cvtColor(cv2.imread(png, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(np.load(tmp_path / "img.npy"), ref)
    np.testing.assert_array_equal(read_png(png), ref)
    jpg = cv2.imread(str(tmp_path / "frame.jpg"), cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(np.load(tmp_path / "jpg.npy"), jpg)
    fill = np.zeros((40, 56), np.uint8)
    cv2.fillPoly(fill, [np.round(np.asarray(p, np.float64).reshape(-1, 2)).astype(np.int32)
                        for p in POLYS], 1)
    np.testing.assert_array_equal(np.load(tmp_path / "poly.npy"), fill.astype(bool))


# ---------------------------------------------------------------- train


@pytest.fixture
def out_dir(tmp_path):
    """The CLI's output directory, removed after the test: each checkpoint of
    the full-width detector holds ~600 MB."""
    out = tmp_path / "out"
    yield out
    shutil.rmtree(out, ignore_errors=True)


def test_cli_train_and_resume(coco_set, out_dir):
    out = str(out_dir)
    base = ["--train-dataset", "cutler_cli_syn", "--test-dataset", "cutler_cli_syn",
            "--output-dir", out, "--max-images", "1", *SMALL]
    printed = _run(base + ["--max-iter", "1", "--base-lr", "0.001", "--lr-multiplier", "0.5",
                           "--lr-multiplier-names", "mask_head", "--copy-paste",
                           "--copy-paste-rate", "1.0"])
    assert "bbox/AP" in printed and "segm/AP" in printed
    lines = [json.loads(x) for x in open(os.path.join(out, "metrics.json"))]
    assert [x["iteration"] for x in lines] == [0]
    assert all(np.isfinite(x["total_loss"]) for x in lines)
    assert os.listdir(os.path.join(out, "checkpoints")) == ["1"]
    saved = torch.load(os.path.join(out, "checkpoints", "1", "state.pt"), weights_only=True,
                       mmap=True)
    assert saved["step"] == 1 and saved["optimizer"]["count"] == 1

    # the second micro-step pastes the first image into the second
    printed = _run(base + ["--max-iter", "2", "--resume", "--no-segm", "--copy-paste"])
    assert "Resumed from checkpoint step 1" in printed
    assert "bbox/AP" in printed and "segm/AP" not in printed  # --no-segm: no mask task
    lines = [json.loads(x) for x in open(os.path.join(out, "metrics.json"))]
    assert [x["iteration"] for x in lines] == [0, 1]
    resumed = torch.load(os.path.join(out, "checkpoints", "2", "state.pt"), weights_only=True,
                         mmap=True)
    assert resumed["optimizer"]["count"] == 2
    moved = [not torch.equal(resumed["model"][k], saved["model"][k]) for k in saved["model"]]
    assert sum(moved) > len(moved) // 2


# ---------------------------------------------------------------- eval


@pytest.fixture(scope="module")
def eval_weights():
    """Port-made weights (torch's init; flax's init of the R50 takes 15-35 s
    here) with the delta heads scaled down, so that the detections stay
    inside the image; the same tensors as JAX params."""
    torch.manual_seed(1)
    model = pc.CutlerRCNN(pc.CutlerConfig(num_proposals=16))
    with torch.no_grad():
        model.rpn.deltas.weight.mul_(0.01)
        for si in range(3):
            getattr(model, f"box_stage{si}").box.weight.mul_(0.1)
    state = model.state_dict()
    flat = from_jax.params_to_jax(state)
    return state, unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _jax_eval(params, dicts, cfg, tta_sizes):
    """JAX's infer + finalize (tools/train_net.py:224-266) and its TTA pass's
    boxes (:316-377), on the same records: (preds, pred_masks, tta_preds).
    The TTA's mask pass (the forward with mask_boxes=, another R50 compile
    here) is held to JAX in tests/test_torch_cutler.py."""
    model = jc.CutlerRCNN(cfg=cfg.rcnn)

    mean, std = np.asarray(cfg.pixel_mean, np.float32), np.asarray(cfg.pixel_std, np.float32)

    @jax.jit
    def infer(params, image_u8):
        image = (image_u8.astype(jnp.float32) - jnp.asarray(cfg.pixel_mean)) / jnp.asarray(cfg.pixel_std)
        out = model.apply(params, image)
        return jt.cascade_detections(out, cfg.rcnn.num_classes, cfg.score_thresh, cfg.nms_thresh,
                                     cfg.detections_per_image, with_masks=True)

    def infer_boxes(params, image):
        # the TTA's normalized canvas through the same executable (a second
        # R50 compile costs ~10 s here): un-normalized, then normalized in it
        return infer(params, np.asarray(image) * std + mean)[:4]

    def entries(record, det, masks):
        preds, pred_masks = [], []
        for di, (b, sc, cl, v) in enumerate(zip(*det)):
            if v:
                preds.append({"image_id": record["image_id"], "category_id": int(cl),
                              "bbox": [float(x) for x in b], "score": float(sc)})
                pred_masks.append({"image_id": record["image_id"], "category_id": int(cl),
                                   "score": float(sc), "segmentation": jrle.encode(masks[di])})
        return preds, pred_masks

    preds, pred_masks, tta_preds = [], [], []
    for record in dicts:
        s = jt.map_image_record(record, cfg, is_train=False, normalize=False)
        det = [np.asarray(x) for x in infer(params, s["image"][None].astype(np.float32))]
        boxes = det[0] / s["scale"]
        p, pm = entries(record, [boxes] + det[1:4],
                        jt.paste_masks(det[4], boxes, s["orig_hw"]))
        preds += p
        pred_masks += pm
        img = read_png(record["file_name"]).astype(np.float32)
        res = jtta.tta_inference(
            params, img, infer_boxes=infer_boxes, infer_masks=None,
            min_sizes=tta_sizes, max_size=cfg.test_aug_max_size, flip=True,
            pixel_mean=cfg.pixel_mean, pixel_std=cfg.pixel_std, nms_thresh=cfg.nms_thresh,
            topk=cfg.detections_per_image)
        tta_preds += entries(record, [np.asarray(x) for x in res], np.zeros((len(res[0]), H, W), bool))[0]
    return preds, pred_masks, tta_preds


def _same_detections(got, ref, got_masks=None, ref_masks=None):
    assert len(got) == len(ref) and len(got) > 0
    assert [(g["image_id"], g["category_id"]) for g in got] == \
        [(r["image_id"], r["category_id"]) for r in ref]
    np.testing.assert_allclose([g["bbox"] for g in got], [r["bbox"] for r in ref],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose([g["score"] for g in got], [r["score"] for r in ref],
                               rtol=1e-3, atol=1e-6)
    if got_masks is not None:
        agree = [np.mean(prle.decode(g["segmentation"]) == jrle.decode(r["segmentation"]))
                 for g, r in zip(got_masks, ref_masks)]
        assert min(agree) >= 0.999, min(agree)


def test_cli_eval_and_tta_match_jax(coco_set, eval_weights, out_dir, monkeypatch):
    """--eval-only --tta from a checkpoint of `eval_weights`: the detections
    and masks handed to the AP functions equal JAX's (the TTA pass's
    detections too)."""
    state, params = eval_weights
    out = out_dir
    save_checkpoint(str(out / "checkpoints"), 7, {"model": state})
    calls = {"boxes": [], "masks": []}
    real_boxes, real_masks = ytvos_eval.evaluate_detections_boxes, ytvos_eval.evaluate_detections_masks

    def capture(kind, real):
        def fn(gts, preds, use_cats=True):
            calls[kind].append(preds)
            return real(gts, preds, use_cats=use_cats)
        return fn

    monkeypatch.setattr(ytvos_eval, "evaluate_detections_boxes", capture("boxes", real_boxes))
    monkeypatch.setattr(ytvos_eval, "evaluate_detections_masks", capture("masks", real_masks))
    argv = ["--eval-only", "--test-dataset", "cutler_cli_syn", "--output-dir", str(out), *SMALL]
    printed = _run(argv + ["--tta", "--tta-min-sizes", *TTA_SIZES])
    assert "Loaded checkpoint step 7" in printed
    for key in ("bbox/AP", "segm/AP", "bbox_TTA/AP", "segm_TTA/AP"):
        assert key + ":" in printed, key
    assert len(calls["boxes"]) == 2 and len(calls["masks"]) == 2

    cfg = jt.CutlerTrainerConfig(rcnn=jc.CutlerConfig(num_proposals=16), image_size=64,
                                 min_size_train=64, max_instances=4)
    dicts, _ = jcoco.load_coco_json(*coco_set, True)
    ref = _jax_eval(params, dicts, cfg, tuple(int(x) for x in TTA_SIZES))
    _same_detections(calls["boxes"][0], ref[0], calls["masks"][0], ref[1])
    _same_detections(calls["boxes"][1], ref[2])

