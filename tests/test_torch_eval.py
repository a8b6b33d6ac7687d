"""The port's --eval-only path against the JAX package, on the CPU: the RLE
codec (native and numpy routes), the AP of `ytvos_eval`, the dataset
registry, the eval mapper, the evaluator's pipeline, `evaluate_dataset`
end to end (results.json and AP) and the CLI.

The end-to-end test runs both evaluators on the tiny synthetic set and
config of tests/test_evaluator_e2e.py with one set of weights (JAX's init,
carried to the port by `params_from_jax`), with videos of 3 and 9 frames so
that both T-buckets (8 and 16) and their pad frames are covered.
"""
import contextlib
import copy
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from hypothesis.extra import numpy as hnp

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from s2d_tpu.config import load_config as jax_load_config
from s2d_tpu.data import rle as jax_rle
from s2d_tpu.data import ytvis as jax_ytvis
from s2d_tpu.evaluation import evaluator as jax_evaluator
from s2d_tpu.evaluation import ytvos_eval as jax_ytvos
from s2d_tpu.models import build_model as jax_build_model

from s2d_tpu_torch import native, train_net_video
from s2d_tpu_torch.config import from_s2d_config, load_config_tree
from s2d_tpu_torch.data import mapper as port_mapper
from s2d_tpu_torch.data import rle, ytvis
from s2d_tpu_torch.demo_video import VideoPredictor
from s2d_tpu_torch.evaluation import evaluator, ytvos_eval
from s2d_tpu_torch.ops import masked_attention_cuda, ms_deform_attn_cuda, nms


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_OPTS = [
    "MODEL.MASK_FORMER.HIDDEN_DIM", "32",
    "MODEL.SEM_SEG_HEAD.MASK_DIM", "32",
    "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "8",
    "MODEL.MASK_FORMER.NHEADS", "4",
    "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "64",
    "MODEL.MASK_FORMER.DEC_LAYERS", "2",
    "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1",
    "MODEL.MASK_FORMER.TEST.NUM_PREDICTIONS", "4",
    "INPUT.MIN_SIZE_TEST", "64",
    "SOLVER.AMP.ENABLED", "False",
]
H, W = 64, 96
LENGTHS = (3, 9)  # T-buckets 8 and 16
METRIC_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100")


@contextlib.contextmanager
def rle_route(name):
    """The port's codec through its native library, or through its numpy
    paths (the library reported missing)."""
    if name == "native":
        assert native.lib() is not None, "the port's native RLE library did not build"
        yield
    else:
        with mock.patch.object(native, "lib", lambda: None):
            yield


# ------------------------------------------------------------------ RLE


@pytest.mark.parametrize("route", ["native", "numpy"])
@settings(max_examples=40, deadline=None)
@given(
    mask=hnp.arrays(bool, hnp.array_shapes(min_dims=2, max_dims=2, min_side=1, max_side=24)),
    seed=st.integers(0, 2**31 - 1),
)
def test_rle_matches_jax(route, mask, seed):
    rng = np.random.RandomState(seed)
    other = rng.rand(*mask.shape) > rng.rand()
    big = list(rng.randint(0, 10**rng.randint(1, 8), size=rng.randint(1, 40)))
    ch, cw = rng.randint(0, mask.shape[0] + 1), rng.randint(0, mask.shape[1] + 1)
    canvas = (mask.shape[0] + rng.randint(0, 9), mask.shape[1] + rng.randint(0, 9))
    y0, x0 = rng.randint(0, canvas[0] - ch + 1), rng.randint(0, canvas[1] - cw + 1)
    ref = jax_rle.encode(mask)
    ref_other = jax_rle.encode(other)
    with rle_route(route):
        enc = rle.encode(mask)
        assert enc == ref
        np.testing.assert_array_equal(rle.decode(enc), mask)
        np.testing.assert_array_equal(rle.mask_to_counts(mask), jax_rle.mask_to_counts(mask))
        assert rle.string_to_counts(enc["counts"]) == jax_rle.string_to_counts(ref["counts"])
        assert rle.string_to_counts(enc["counts"].encode()) == jax_rle.string_to_counts(ref["counts"])
        assert rle.counts_to_string(big) == jax_rle.counts_to_string(big)
        assert rle.string_to_counts(rle.counts_to_string(big)) == big
        np.testing.assert_array_equal(rle.rle_counts(enc), jax_rle.rle_counts(ref))
        assert rle.area(enc) == jax_rle.area(ref) == int(mask.sum())
        assert rle.to_bbox(enc) == jax_rle.to_bbox(ref)
        assert (rle.iou_intersection_union(enc, rle.encode(other))
                == jax_rle.iou_intersection_union(ref, ref_other))
        crop = mask[:ch, :cw]
        assert (rle.encode_window(crop, y0, x0, *canvas)
                == jax_rle.encode_window(crop, y0, x0, *canvas))


def test_native_library_is_the_ports_own_build():
    assert native.lib() is not None
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "s2d_tpu_torch")


def test_polygons_to_mask_matches_jax():
    polys = [[2.0, 3.0, 20.5, 4.0, 11.0, 17.9], [1, 1, 2, 1]]  # the second is too short
    np.testing.assert_array_equal(rle.polygons_to_mask(polys, 20, 24),
                                  jax_rle.polygons_to_mask(polys, 20, 24))


# ------------------------------------------------------------------ AP


def _rect(h, w, rng):
    m = np.zeros((h, w), bool)
    y0, x0 = rng.randint(0, h - 8), rng.randint(0, w - 8)
    m[y0:y0 + rng.randint(4, h - y0), x0:x0 + rng.randint(4, w - x0)] = True
    return m


def synthetic_tracks(seed, h=300, w=400, t=3):
    """GT and predicted tracks over 3 videos: rectangles of every COCO area
    range, absent frames (None), two categories, predictions that are
    shifted copies of the GT or stray, scores with ties."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for vid in (1, 2, 3):
        tracks = []
        for _ in range(rng.randint(1, 4)):
            masks = [_rect(h, w, rng) if rng.rand() > 0.2 else None for _ in range(t)]
            cat = int(rng.randint(1, 3))
            gts.append({"video_id": vid, "category_id": cat, "iscrowd": 0,
                        "segmentations": [None if m is None else jax_rle.encode(m) for m in masks]})
            tracks.append((cat, masks))
        for _ in range(rng.randint(2, 7)):
            if tracks and rng.rand() < 0.7:
                cat, masks = tracks[rng.randint(len(tracks))]
                shift = rng.randint(-6, 7)
                masks = [None if m is None else np.roll(m, shift, axis=1) for m in masks]
            else:
                cat, masks = int(rng.randint(1, 3)), [_rect(h, w, rng) for _ in range(t)]
            dts.append({"video_id": vid, "category_id": cat,
                        "score": float(np.round(rng.rand(), 1)),
                        "segmentations": [None if m is None else jax_rle.encode(m) for m in masks]})
    return gts, dts


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_vis_matches_jax_exactly(route, seed):
    gts, dts = synthetic_tracks(seed)
    for use_cats in (False, True):
        ref = jax_ytvos.evaluate_vis(copy.deepcopy(gts), copy.deepcopy(dts), use_cats=use_cats)
        with rle_route(route):
            got = ytvos_eval.evaluate_vis(copy.deepcopy(gts), copy.deepcopy(dts), use_cats=use_cats)
        assert list(got) == list(ref) == list(METRIC_KEYS)
        np.testing.assert_equal(got, ref)  # bit for bit, nan where JAX has nan
    assert 0.0 < ref["AP"] < 1.0


def test_image_detection_ap_matches_jax():
    rng = np.random.RandomState(3)
    gts, dets = [], []
    for image_id in range(4):
        for _ in range(3):
            m = _rect(60, 80, rng)
            ys, xs = np.nonzero(m)
            box = [float(xs.min()), float(ys.min()), float(xs.max() + 1), float(ys.max() + 1)]
            gts.append({"image_id": image_id, "category_id": 1, "bbox": box,
                        "segmentation": jax_rle.encode(m)})
            shifted = np.roll(m, rng.randint(-3, 4), axis=0)
            dets.append({"image_id": image_id, "category_id": 1, "score": float(rng.rand()),
                         "bbox": [b + rng.randint(-2, 3) for b in box],
                         "segmentation": jax_rle.encode(shifted)})
    for fn in ("evaluate_detections_masks", "evaluate_detections_boxes"):
        got = getattr(ytvos_eval, fn)(copy.deepcopy(gts), copy.deepcopy(dets))
        np.testing.assert_equal(got, getattr(jax_ytvos, fn)(copy.deepcopy(gts), copy.deepcopy(dets)))


# ------------------------------------------------------------------ data


def write_ytvis(root, lengths=LENGTHS, h=H, w=W, frames=True, categories=None):
    """A YTVIS json (and, with `frames`, jpg frames) under `root`: one video
    per length, one box instance each, absent in its last frame."""
    import cv2

    videos, annotations = [], []
    for vid, t in enumerate(lengths, start=1):
        files = [f"v{vid}/{fi:05d}.jpg" for fi in range(t)]
        if frames:
            (root / f"v{vid}").mkdir(parents=True, exist_ok=True)
            for fi, name in enumerate(files):
                img = np.random.RandomState(vid * 100 + fi).randint(0, 255, (h, w, 3), np.uint8)
                cv2.imwrite(str(root / name), img)
        videos.append({"id": vid, "file_names": files, "height": h, "width": w, "length": t})
        mask = np.zeros((h, w), bool)
        mask[h // 4:h // 2 + 8, w // 4:w // 2 + 16] = True
        segs = [jax_rle.encode(mask)] * (t - 1) + [None]
        annotations.append({"id": vid, "video_id": vid, "category_id": 3 if vid % 2 else 1,
                            "segmentations": segs, "bboxes": None, "iscrowd": 0})
    data = {"videos": videos, "annotations": annotations,
            "categories": categories or [{"id": 3, "name": "b"}, {"id": 1, "name": "a"}]}
    path = root / "valid.json"
    path.write_text(json.dumps(data))
    return path


@pytest.fixture
def fresh_registries(monkeypatch):
    monkeypatch.setattr(ytvis, "DATASET_REGISTRY", {})
    monkeypatch.setattr(jax_ytvis, "DATASET_REGISTRY", {})


def test_dataset_records_match_jax(tmp_path, monkeypatch, fresh_registries):
    json_path = write_ytvis(tmp_path, frames=False)
    for agnostic in (False, True):
        assert (ytvis.load_ytvis_json(str(json_path), str(tmp_path), agnostic)
                == jax_ytvis.load_ytvis_json(str(json_path), str(tmp_path), agnostic))
    # a builtin name resolves under $S2D_DATASETS, as JAX's
    root = tmp_path / "datasets"
    (root / "ytvis_2021" / "valid").mkdir(parents=True)
    json_path.rename(root / "ytvis_2021" / "valid" / "instances.json")
    monkeypatch.setenv("S2D_DATASETS", str(root))
    for name in ("ytvis_2021_valid", "ytvis_2021_valid_cls_agnostic"):
        got = ytvis.get_dataset(name)
        assert got == jax_ytvis.get_dataset(name)
        assert got[0][0]["file_names"][0] == str(root / "ytvis_2021/valid/JPEGImages/v1/00000.jpg")
    with pytest.raises(KeyError, match="Unknown dataset"):
        ytvis.get_dataset("no_such_set")


def test_eval_mapper_matches_jax(tmp_path, monkeypatch):
    from s2d_tpu.data.mapper import ClipMapper, MapperConfig

    # 48x80 frames: the shortest edge goes to 64, so the frames are resized
    write_ytvis(tmp_path, lengths=(2,), h=48, w=80)
    record = ytvis.load_ytvis_json(str(tmp_path / "valid.json"), str(tmp_path))[0][0]
    cfg = jax_load_config(None, opts=TINY_OPTS)
    ref = ClipMapper(MapperConfig.from_config(cfg, is_train=False), is_train=False)(record)
    got = port_mapper.EvalMapper(64, 1333)(record)
    assert got["image"].dtype == np.uint8 and got["image"].shape == (2, 64, 107, 3)
    np.testing.assert_array_equal(got["image"], ref["image"])
    for key in ("video_id", "height", "width", "selected_idx"):
        assert got[key] == ref[key]
    # without cv2 a frame at the test size passes as it is, and a resize is
    # cv2's, exactly (the port's resize_linear)
    frames = np.stack([port_mapper.load_image_robust(f) for f in record["file_names"]])
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert port_mapper.resize_frames(got["image"], (64, 107)) is got["image"]
    np.testing.assert_array_equal(port_mapper.resize_frames(frames, (64, 107)), ref["image"])


# ------------------------------------------------------------------ the evaluator


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_set")
    return write_ytvis(root), root


@pytest.fixture(scope="module")
def tiny_models():
    """(JAX config, model, variables) and the port's predictor, one set of
    weights."""
    cfg = jax_load_config(None, opts=TINY_OPTS)
    model = jax_build_model(cfg, compute_dtype=jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, H, W, 3)))
    flat = {"/".join(k): np.array(v) for k, v in flatten_dict(variables).items()}
    vcfg = from_s2d_config(load_config_tree(None, TINY_OPTS))
    return (cfg, model, variables), VideoPredictor(vcfg, weights=flat, device="cpu")


def _register(name, tiny_set):
    json_path, root = tiny_set
    ytvis.register_ytvis(name, str(json_path), str(root), class_agnostic=True)
    jax_ytvis.register_ytvis(name, str(json_path), str(root), class_agnostic=True)


def test_evaluate_dataset_matches_jax(tiny_set, tiny_models, tmp_path, monkeypatch):
    """results.json and AP of the whole slice against JAX's evaluator: the
    same entries in dataset order (video ids, labels), scores at rtol 1e-3 /
    atol 2e-3, decoded masks differing in under 0.5% of the pixels (the
    binarization at logit 0 flips pixels within rounding of 0, as in
    tests/test_torch_slice.py), the same metric keys. Random weights score
    AP 0 against the boxes of the set, so both results lists are also scored
    against JAX's best track per video as ground truth: the same AP within
    0.02. On the CPU no kernel launches."""
    (cfg, model, variables), predictor = tiny_models
    _register("tiny_torch_e2e", tiny_set)
    for mod in (ms_deform_attn_cuda, masked_attention_cuda, nms):
        monkeypatch.setattr(mod, "LAUNCHES", 0)
    ref = jax_evaluator.evaluate_dataset(cfg, model, variables, "tiny_torch_e2e",
                                         output_dir=str(tmp_path / "jax"))
    got = evaluator.evaluate_dataset(predictor, "tiny_torch_e2e", output_dir=str(tmp_path / "port"))
    assert ms_deform_attn_cuda.LAUNCHES == masked_attention_cuda.LAUNCHES == nms.LAUNCHES == 0
    assert list(got) == list(ref)
    assert got["frames_per_second"] > 0
    print({k: (got[k], ref[k]) for k in METRIC_KEYS})
    for key in METRIC_KEYS:
        assert np.isnan(got[key]) == np.isnan(ref[key])
    results = json.loads((tmp_path / "port" / "results.json").read_text())
    ref_results = json.loads((tmp_path / "jax" / "results.json").read_text())
    assert results and len(results) == len(ref_results)
    differ, pixels = 0, 0
    for r, e in zip(results, ref_results):
        assert (r["video_id"], r["category_id"]) == (e["video_id"], e["category_id"])
        np.testing.assert_allclose(r["score"], e["score"], rtol=1e-3, atol=2e-3)
        assert len(r["segmentations"]) == LENGTHS[r["video_id"] - 1]  # no pad frame
        for s, t in zip(r["segmentations"], e["segmentations"]):
            assert s["size"] == t["size"] == [H, W]
            differ += int((rle.decode(s) != jax_rle.decode(t)).sum())
            pixels += H * W
    print(f"decoded mask pixels differing: {differ} of {pixels}")
    assert differ / pixels < 5e-3
    best = {}
    for e in ref_results:
        if e["score"] > best.get(e["video_id"], {"score": -1.0})["score"]:
            best[e["video_id"]] = e
    gt = [{k: e[k] for k in ("video_id", "category_id", "segmentations")} for e in best.values()]
    ap = ytvos_eval.evaluate_vis(copy.deepcopy(gt), results)
    ap_ref = jax_ytvos.evaluate_vis(copy.deepcopy(gt), ref_results)
    print({k: (ap[k], ap_ref[k]) for k in METRIC_KEYS})
    assert ap_ref["AP"] > 0.3
    for key in METRIC_KEYS:
        np.testing.assert_allclose(ap[key], ap_ref[key], atol=0.02)


def test_evaluate_dataset_shards_and_injected_frames(tiny_set, tiny_models, tmp_path):
    """mapper= supplies the frames (no image file is read); num_shards
    writes results_shard{i}.json, which merge and score like one run."""
    _, predictor = tiny_models
    _register("tiny_torch_shards", tiny_set)
    rng = np.random.RandomState(0)
    frames = {vid: rng.randint(0, 255, (t, H, W, 3), np.uint8) for vid, t in enumerate(LENGTHS, 1)}
    mapper = lambda record: {"image": frames[record["video_id"]]}
    out = str(tmp_path / "out")
    whole = evaluator.evaluate_dataset(predictor, "tiny_torch_shards", mapper=mapper)
    for i in range(2):
        evaluator.evaluate_dataset(predictor, "tiny_torch_shards", output_dir=out,
                                   num_shards=2, shard_index=i, mapper=mapper)
    merged = evaluator.merge_shard_results(out, 2)
    assert sorted({r["video_id"] for r in merged}) == [1, 2]
    scored = evaluator.score_results("tiny_torch_shards", merged)
    assert {k: scored[k] for k in METRIC_KEYS} == pytest.approx(
        {k: whole[k] for k in METRIC_KEYS}, nan_ok=True)


def test_evaluator_errors_propagate(tiny_set, tiny_models, monkeypatch):
    """An error on the finalize thread, or in the mapper on the prefetch
    thread, surfaces from evaluate_dataset instead of hanging it."""
    _, predictor = tiny_models
    _register("tiny_torch_errors", tiny_set)

    def boom(*args, **kwargs):
        raise RuntimeError("mask readback exploded")

    with monkeypatch.context() as m:
        m.setattr(evaluator, "predictions_to_results", boom)
        with pytest.raises(RuntimeError, match="mask readback exploded"):
            evaluator.evaluate_dataset(predictor, "tiny_torch_errors")

    def bad_mapper(record):
        raise ValueError(f"no frames for video {record['video_id']}")

    with pytest.raises(ValueError, match="no frames for video 1"):
        evaluator.evaluate_dataset(predictor, "tiny_torch_errors", mapper=bad_mapper)


def test_eval_cli_on_cpu(tmp_path, monkeypatch, fresh_registries, capsys):
    root = tmp_path / "datasets"
    images = root / "ytvis_2021" / "valid" / "JPEGImages"
    images.mkdir(parents=True)
    write_ytvis(images, lengths=(3,)).rename(root / "ytvis_2021" / "valid" / "instances.json")
    monkeypatch.setenv("S2D_DATASETS", str(root))
    out = tmp_path / "out"
    argv = ["--config-file", os.path.join(REPO, "configs",
                                          "s2d_inference_kd_video_mask2former_R50_cls_agnostic.yaml"),
            "--device", "cpu", *TINY_OPTS, "DATASETS.TEST", '("ytvis_2021_valid_cls_agnostic",)',
            "OUTPUT_DIR", str(out), "MODEL.WEIGHTS", '""']
    assert train_net_video.main(["--eval-only", *argv]) == 0
    printed = capsys.readouterr().out
    assert "[ytvis_2021_valid_cls_agnostic] AP: " in printed and "frames_per_second" in printed
    results = json.loads((out / "results.json").read_text())
    assert results and all(len(r["segmentations"]) == 3 for r in results)
    # training reads a registered COCO set as pseudo-clips (its json is not
    # under S2D_DATASETS here, so reading it raises) and raises KeyError for
    # a name no registry holds, both before the train state is built
    with pytest.raises(FileNotFoundError, match="instances_train2017.json"):
        train_net_video.main([*argv, "DATASETS.TRAIN", '("coco_2017_train",)'])
    with pytest.raises(KeyError, match="no_such_set"):
        train_net_video.main([*argv, "DATASETS.TRAIN", '("no_such_set",)'])
    with pytest.raises(NotImplementedError, match="queue 1, item 1"):
        train_net_video.main(["--eval-only", "--time-parallel", *argv])


def test_eval_path_runs_without_jax_cv2_or_pil(tmp_path):
    """With jax, s2d_tpu, yaml, cv2 and PIL blocked on import, the port
    evaluates a dataset on the CPU from injected frames, reads a JPEG as cv2
    reads it, and the ablation modules import; the RLE library it loads is
    its own build, never the JAX package's."""
    import cv2

    json_path = write_ytvis(tmp_path, lengths=(2,), frames=False)
    jpg = tmp_path / "frame.jpg"
    cv2.imwrite(str(jpg), np.random.RandomState(0).randint(0, 256, (24, 40, 3), np.uint8))
    np.save(tmp_path / "cv2.npy", cv2.imread(str(jpg), cv2.IMREAD_COLOR)[..., ::-1])
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'yaml', 's2d_tpu',\n"
        "                                  'cv2', 'PIL'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import json, numpy as np\n"
        "import s2d_tpu_torch.train_net_video, s2d_tpu_torch.tools.bench_pallas_ablate\n"
        "from s2d_tpu_torch.config import VideoConfig\n"
        "from s2d_tpu_torch.data import mapper, rle, ytvis\n"
        "from s2d_tpu_torch.demo_video import VideoPredictor\n"
        "from s2d_tpu_torch.evaluation.evaluator import evaluate_dataset\n"
        f"ytvis.register_ytvis('blocked', {str(json_path)!r}, {str(tmp_path)!r}, True)\n"
        "cfg = VideoConfig(hidden_dim=32, mask_dim=32, num_queries=8, nheads=4,\n"
        "                  dim_feedforward=64, dec_layers=2, enc_layers=1, num_predictions=4)\n"
        "p = VideoPredictor(cfg, device='cpu')\n"
        "frames = np.zeros((2, 64, 96, 3), np.uint8)\n"
        f"m = evaluate_dataset(p, 'blocked', output_dir={str(tmp_path / 'out')!r},\n"
        "                     mapper=lambda r: {'image': frames})\n"
        "assert 'AP' in m and 'stage_s/rle_encode' in m, m\n"
        f"img = mapper.load_image_robust({str(jpg)!r})  # the port's own JPEG codec\n"
        f"assert (img == np.load({str(tmp_path / 'cv2.npy')!r})).all()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'build/s2d_tpu_torch/librle_ops_' in maps, 'the port RLE library is not loaded'\n"
        "assert 's2d_tpu/native' not in maps\n"
    )
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads((tmp_path / "out" / "results.json").read_text())
