"""COCO pseudo-clips for the port's video trainer against JAX's:
`data/image_datasets.coco_to_clip_record` against
`s2d_tpu.data.image_datasets.coco_to_clip_record`, record for record, on a
synthetic COCO set of JPEG images with polygon and RLE segmentations;
`train_net_video.train_datasets` on that set registered in both packages
against the records `tools/train_net_video.py:245-260` builds; one seeded
train `ClipMapper` sample of such a record against JAX's (JAX reads the JPEG
through cv2 and fills the polygons with cv2.fillPoly; the port through its
own codec and fill). Tolerance: exact everywhere; the sample's augmentations
are the integer ones (resize, crop, flip), so its images are equal to the
bit, as are its masks, valid and labels.
"""
import json

import numpy as np
import pytest

import cv2

from s2d_tpu.data import coco as jax_coco
from s2d_tpu.data import image_datasets as jax_image_datasets
from s2d_tpu.data import mapper as jax_mapper
from s2d_tpu.data import rle as jax_rle
from s2d_tpu.data import ytvis as jax_ytvis
from s2d_tpu.data.augment import ClipAugConfig as JaxAugConfig

from s2d_tpu_torch import train_net_video
from s2d_tpu_torch.data import coco, image_datasets, mapper
from s2d_tpu_torch.data.augment import ClipAugConfig

NAME = "tiny_torch_coco_pseudo_clips"
H, W = 60, 84
CLIP_LEN = 3


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    """4 JPEG images, each with a polygon annotation (two parts, one
    leaving the image), an RLE one and a crowd polygon; registered in both
    packages."""
    root = tmp_path_factory.mktemp("coco_pseudo_clips")
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:H, :W]
    images, annotations = [], []
    for i in range(4):
        cv2.imwrite(str(root / f"{i}.jpg"), rng.randint(0, 256, (H, W, 3), np.uint8),
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        images.append({"id": i + 1, "file_name": f"{i}.jpg", "height": H, "width": W})
        poly = [[5.5 + i, 4.0, 40.0, 8.5, 30.0, 50.0, 2.0, 30.0],
                [50.0, 20.0, 95.0, 25.0, 70.0, 58.5]]
        ellipse = ((yy - 30 - i) / 12.0) ** 2 + ((xx - 55) / 20.0) ** 2 < 1
        ys, xs = np.nonzero(ellipse)
        annotations += [
            {"id": 3 * i + 1, "image_id": i + 1, "category_id": 1, "iscrowd": 0,
             "bbox": [2.0, 4.0, 93.0, 54.5], "area": 1000.0, "segmentation": poly},
            {"id": 3 * i + 2, "image_id": i + 1, "category_id": 2, "iscrowd": 0,
             "bbox": [float(xs.min()), float(ys.min()), float(np.ptp(xs) + 1), float(np.ptp(ys) + 1)],
             "area": float(ellipse.sum()), "segmentation": jax_rle.encode(ellipse)},
            {"id": 3 * i + 3, "image_id": i + 1, "category_id": 1, "iscrowd": 1,
             "bbox": [60.0, 40.0, 10.0, 10.0], "area": 100.0,
             "segmentation": [[60.0, 40.0, 70.0, 40.0, 70.0, 50.0, 60.0, 50.0]]},
        ]
    for a in annotations:
        if isinstance(a["segmentation"], dict) and isinstance(a["segmentation"]["counts"], bytes):
            a["segmentation"]["counts"] = a["segmentation"]["counts"].decode("ascii")
    path = root / "instances.json"
    path.write_text(json.dumps({"images": images, "annotations": annotations,
                                "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}))
    coco.register_coco(NAME, str(path), str(root), False)
    jax_coco.register_coco(NAME, str(path), str(root), False)
    mine, _ = coco.get_coco_dataset(NAME)
    theirs, _ = jax_coco.get_coco_dataset(NAME)
    assert mine == theirs
    return mine


@pytest.mark.parametrize("clip_len", [1, CLIP_LEN])
def test_coco_to_clip_record_equals_jax(coco_set, clip_len):
    for record in coco_set:
        got = image_datasets.coco_to_clip_record(record, clip_len)
        assert got == jax_image_datasets.coco_to_clip_record(record, clip_len)
        assert got["file_names"] == [record["file_name"]] * clip_len
        assert len(got["annotations"]) == 3


def test_train_datasets_equals_the_jax_trainers_records(coco_set):
    """`tools/train_net_video.py:245-260`: a name that is no YTVIS set but a
    registered COCO set becomes pseudo-clips of SAMPLING_FRAME_NUM frames; an
    unknown name raises KeyError."""
    want = []
    for name in (NAME, NAME):
        try:
            d, _ = jax_ytvis.get_dataset(name)
        except KeyError:
            imgs, _ = jax_coco.get_coco_dataset(name)
            d = [jax_image_datasets.coco_to_clip_record(r, CLIP_LEN) for r in imgs]
        want.extend(d)
    assert train_net_video.train_datasets((NAME, NAME), CLIP_LEN) == want
    with pytest.raises(KeyError):
        train_net_video.train_datasets(("no_such_set",), CLIP_LEN)


def test_clip_mapper_sample_of_a_pseudo_clip_equals_jax(coco_set):
    aug = dict(min_sizes=(48, 56), max_size=1333, crop_enabled=True, crop_range=(40, 52))
    mine = mapper.ClipMapper(mapper.MapperConfig(sampling_frame_num=CLIP_LEN, max_instances=6,
                                                 aug=ClipAugConfig(**aug)), seed=3)
    theirs = jax_mapper.ClipMapper(jax_mapper.MapperConfig(sampling_frame_num=CLIP_LEN,
                                                           max_instances=6,
                                                           aug=JaxAugConfig(**aug)), seed=3)
    for record in coco_set[:2]:
        got = mine(image_datasets.coco_to_clip_record(record, CLIP_LEN))
        want = theirs(jax_image_datasets.coco_to_clip_record(record, CLIP_LEN))
        assert got["selected_idx"] == [int(i) for i in want["selected_idx"]]
        for key in ("image", "masks", "valid", "labels"):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["valid"].sum() >= 2 and got["masks"].any()
    # CocoClipMapper is the same mapper over the image record itself
    coco_mapper = image_datasets.CocoClipMapper(mine.cfg, seed=3)
    again = mapper.ClipMapper(mine.cfg, seed=3)(
        image_datasets.coco_to_clip_record(coco_set[0], CLIP_LEN))
    got = coco_mapper(coco_set[0])
    for key in ("image", "masks", "valid", "labels"):
        np.testing.assert_array_equal(got[key], again[key])


def test_the_video_trainer_trains_on_a_coco_set(coco_set, tmp_path, monkeypatch):
    """`train_net_video.main` with DATASETS.TRAIN a registered COCO set: one
    step on the CPU (the tiny model of tests/test_torch_train_cli.py) over
    pseudo-clips read from the JPEGs, finite losses in metrics.json."""
    import shutil
    import sys

    import torch

    from test_torch_train_cli import TINY_OPTS

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path / "out"
    try:
        assert train_net_video.main(["--device", "cpu", *TINY_OPTS, "DATASETS.TRAIN", f'("{NAME}",)',
                                     "SOLVER.MAX_ITER", "1", "TEST.EVAL_PERIOD", "0",
                                     "OUTPUT_DIR", str(out)]) == 0
        (line,) = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
        assert line["iteration"] == 0 and line["grad_finite"] == 1.0
        assert all(np.isfinite(v) for k, v in line.items() if "loss" in k)
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(out, ignore_errors=True)  # a checkpoint of the tiny model holds ~400 MB
