"""The port's train data path against `s2d_tpu.data` on the CPU, with the
same records and the same seeds: the train `ClipMapper` (dense
selection, the sparse fallback, crop, flip, brightness, contrast and
rotation), `augment_clip`'s affines, `collate_clips`, the first batches of
`train_loader` (one and two shards) and the clip copy-paste.

The records are a tiny synthetic YTVIS set of JPEG frames, annotated
sparsely (keymask-style): each instance on a window of frames and None
elsewhere. Tolerances: selected frames, kept instances, masks, valid and
labels identical; images within 0.02 after normalization (1 grey level
over PIXEL_STD is ~0.017). With copy-paste the pasted frames go through a
float32 bilinear resize, which the port holds to 1e-3 grey levels of cv2
(tests/test_torch_transforms.py): well inside 0.02.
"""
import dataclasses
import json

import numpy as np
import pytest

import cv2

from s2d_tpu.data import copy_paste as jax_cp
from s2d_tpu.data import loader as jax_loader
from s2d_tpu.data import mapper as jax_mapper
from s2d_tpu.data import rle as jax_rle
from s2d_tpu.data import ytvis as jax_ytvis
from s2d_tpu.data.augment import ClipAugConfig as JaxAugConfig

from s2d_tpu_torch.config import load_config_tree
from s2d_tpu_torch.data import copy_paste, loader, mapper, ytvis
from s2d_tpu_torch.data.augment import ClipAugConfig

H, W = 72, 104
MEAN = (123.675, 116.280, 103.530)
STD = (58.395, 57.120, 57.375)
IMAGE_ATOL = 0.02
# frame windows of each video's instances: video 3 has no window of 3
# consecutive annotated frames (its selection falls back to sparse)
WINDOWS = {1: [(0, 5), (2, 8), (4, 7)], 2: [(1, 4), (0, 9)], 3: [(0, 2), (5, 7), (8, 9)],
           4: [(3, 9), (0, 3), (2, 6), (6, 9)]}
LENGTH = 9
DATASET = "tiny_torch_train_data"


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A YTVIS train set of JPEG frames, registered in both packages."""
    root = tmp_path_factory.mktemp("train_data")
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:H, :W]
    videos, annotations = [], []
    for vid, windows in WINDOWS.items():
        files = [f"v{vid}/{i:05d}.jpg" for i in range(LENGTH)]
        (root / f"v{vid}").mkdir()
        for name in files:
            cv2.imwrite(str(root / name), rng.randint(0, 256, (H, W, 3), np.uint8))
        videos.append({"id": vid, "file_names": files, "height": H, "width": W, "length": LENGTH})
        for j, (lo, hi) in enumerate(windows):
            cy, cx = rng.uniform(0.3, 0.7) * H, rng.uniform(0.3, 0.7) * W
            ry, rx = rng.uniform(0.1, 0.3) * H, rng.uniform(0.1, 0.3) * W
            segs = [jax_rle.encode(((yy - cy - i) / ry) ** 2 + ((xx - cx + i) / rx) ** 2 < 1)
                    if lo <= i < hi else None for i in range(LENGTH)]
            annotations.append({"id": 10 * vid + j, "video_id": vid, "category_id": 1 + j % 2,
                                "segmentations": segs, "iscrowd": 0})
    path = root / "train.json"
    path.write_text(json.dumps({"videos": videos, "annotations": annotations,
                                "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}))
    jax_ytvis.register_ytvis(DATASET, str(path), str(root))
    ytvis.register_ytvis(DATASET, str(path), str(root))
    port_records, _ = ytvis.get_dataset(DATASET)
    jax_records, _ = jax_ytvis.get_dataset(DATASET)
    assert port_records == jax_records
    return port_records


def _aug(cls, **kw):
    base = dict(min_sizes=(48, 64), max_size=1333, crop_enabled=True, crop_range=(40, 64),
                brightness=True, contrast=True, rotation=True)
    base.update(kw)
    return cls(**base)


def _mappers(seed, **kw):
    mine = mapper.MapperConfig(sampling_frame_num=3, max_instances=6, aug=_aug(ClipAugConfig, **kw))
    theirs = jax_mapper.MapperConfig(sampling_frame_num=3, max_instances=6,
                                     aug=_aug(JaxAugConfig, **kw))
    return mapper.ClipMapper(mine, seed=seed), jax_mapper.ClipMapper(theirs, seed=seed)


def _assert_sample(got, want, image_atol=IMAGE_ATOL):
    assert got["selected_idx"] == [int(i) for i in want["selected_idx"]]
    for key in ("masks", "valid", "labels"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["image"].dtype == want["image"].dtype and got["image"].shape == want["image"].shape
    std = np.asarray(STD, np.float32)
    np.testing.assert_allclose(got["image"] / std, want["image"] / std, rtol=0, atol=image_atol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clip_mapper_train_matches_jax(records, seed):
    """Several draws a record; both selections run (video 3 has no dense
    window), and the kept instances, masks, valid, labels and images agree."""
    mine, theirs = _mappers(seed)
    kinds = set()
    for record in records * 2:
        got, want = mine(record), theirs(record)
        _assert_sample(got, want)
        sel = got["selected_idx"]
        kinds.add("dense" if sel == list(range(sel[0], sel[0] + 3)) and record["video_id"] != 3
                  else "sparse")
        assert got["image"].dtype == np.float32 and 0 < got["valid"].sum() <= 6
    assert kinds == {"dense", "sparse"}


@pytest.mark.parametrize("kw", [dict(crop_enabled=False, flip_prob=1.0),
                                dict(rotation=False, brightness=False, saturation=True),
                                dict(min_sizes=(200,), max_size=150)])
def test_clip_mapper_options_match_jax(records, kw):
    mine, theirs = _mappers(5, **kw)
    for record in records:
        _assert_sample(mine(record), theirs(record))


def test_clip_mapper_without_dense_selection(records):
    mine, theirs = _mappers(3)
    mine.cfg = dataclasses.replace(mine.cfg, dense_selection=False)
    theirs.cfg = dataclasses.replace(theirs.cfg, dense_selection=False)
    for record in records:
        _assert_sample(mine(record), theirs(record))


def test_augment_clip_affines_match_jax(records):
    """return_affines: the per-frame original -> augmented pixel maps (the
    record the disentangled view replays) agree with JAX's."""
    from s2d_tpu.data.augment import augment_clip as jax_augment
    from s2d_tpu_torch.data.augment import augment_clip

    frames = [cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2RGB) for f in records[0]["file_names"][:3]]
    masks = np.random.RandomState(0).rand(2, 3, H, W) > 0.5
    for seed in range(3):
        got = augment_clip(np.random.RandomState(seed), frames, masks.copy(), _aug(ClipAugConfig),
                           return_affines=True)
        want = jax_augment(np.random.RandomState(seed), frames, masks.copy(), _aug(JaxAugConfig),
                           True, return_affines=True)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(np.stack(got[0]), np.stack(want[0]), rtol=0, atol=1e-3)


def test_frames_from_a_reader(records):
    """read_frames= replaces the image files: the same frames give the same
    sample, and no file is read."""
    frames = {r["video_id"]: [cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2RGB)
                              for f in r["file_names"]] for r in records}
    cfg = mapper.MapperConfig(sampling_frame_num=3, max_instances=6, aug=_aug(ClipAugConfig))
    injected = mapper.ClipMapper(cfg, seed=4, read_frames=lambda record, idx: [
        frames[record["video_id"]][i] for i in idx])
    from_files = mapper.ClipMapper(cfg, seed=4)
    missing = [dict(r, file_names=[f + ".missing" for f in r["file_names"]]) for r in records]
    for record, gone in zip(records, missing):
        _assert_sample(injected(gone), from_files(record), image_atol=0)


def test_disentangled_view_raises(records):
    """The disentangled view no longer raises (it did until it was ported):
    a disentangling mapper returns the distillation view and its affines,
    the same as JAX's on one seed (tests/test_torch_train_options.py holds
    more draws)."""
    mine, theirs = _mappers(2)
    mine.cfg = dataclasses.replace(mine.cfg, disentangle=True)
    theirs.cfg = dataclasses.replace(theirs.cfg, disentangle=True)
    got, want = mine(records[0]), theirs(records[0])
    _assert_sample(got, want)
    np.testing.assert_array_equal(got["distill_affine"], want["distill_affine"])
    assert got["distill_image"].shape == want["distill_image"].shape


def test_mapper_config_from_the_kd_config():
    cfg = load_config_tree("configs/ytvis2021_kd_video_mask2former_R50_cls_agnostic.yaml")
    mc = mapper.MapperConfig.from_config(cfg)
    assert (mc.sampling_frame_num, mc.max_instances, mc.dense_selection) == (3, 40, True)
    assert mc.aug.crop_enabled and mc.aug.crop_range == (600, 720)
    assert (mc.aug.brightness, mc.aug.contrast, mc.aug.rotation, mc.aug.saturation) == (
        True, True, True, False)
    assert tuple(mc.aug.min_sizes) == (360, 480)


def test_collate_matches_jax(records):
    mine, _ = _mappers(7)
    samples = [mine(r) for r in records]
    assert len({s["image"].shape for s in samples}) > 1  # different canvases
    got = loader.collate_clips(samples, MEAN, STD)
    want = jax_loader.collate_clips(samples, MEAN, STD, pack_masks=False)
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    packed = loader.collate_clips(samples, MEAN, STD, pack_masks=True)
    np.testing.assert_array_equal(
        packed["masks"], jax_loader.collate_clips(samples, MEAN, STD, pack_masks=True)["masks"])
    np.testing.assert_array_equal(np.unpackbits(packed["masks"], axis=-1).astype(bool), got["masks"])


def _assert_batches(mine, theirs, n=3):
    for _ in range(n):
        got, want = next(mine), next(theirs)
        assert set(got) == set(want) == {"images", "masks", "valid"}
        assert got["images"].shape == want["images"].shape
        np.testing.assert_allclose(got["images"], want["images"], rtol=0, atol=IMAGE_ATOL)
        np.testing.assert_array_equal(got["masks"], want["masks"])
        np.testing.assert_array_equal(got["valid"], want["valid"])


@pytest.mark.parametrize("num_shards", [1, 2])
def test_train_loader_matches_jax(records, num_shards):
    for shard in range(num_shards):
        mine_m, theirs_m = _mappers(11 + shard)
        mine = loader.train_loader(records, mine_m, 2, MEAN, STD, seed=3, num_shards=num_shards,
                                   shard_index=shard)
        theirs = jax_loader.train_loader(records, theirs_m, 2, MEAN, STD, seed=3,
                                         num_shards=num_shards, shard_index=shard,
                                         pack_masks=True)
        try:
            _assert_batches(mine, theirs)
        finally:
            mine.close()


def test_train_loader_with_copy_paste_matches_jax(records):
    mine_m, theirs_m = _mappers(13)
    mine_rng, theirs_rng = np.random.RandomState(7), np.random.RandomState(7)
    mine = loader.train_loader(
        records, mine_m, 3, MEAN, STD, seed=5,
        batch_transform=lambda s: copy_paste.apply_clip_copy_paste(s, mine_rng))
    theirs = jax_loader.train_loader(
        records, theirs_m, 3, MEAN, STD, seed=5, pack_masks=True,
        batch_transform=lambda s: jax_cp.apply_clip_copy_paste(s, theirs_rng))
    try:
        _assert_batches(mine, theirs)
    finally:
        mine.close()


def test_loader_errors_and_close(records):
    """An error on the loader thread reaches the consumer; close() stops
    the thread of an infinite loader."""
    def bad(record):
        raise ValueError("no frames")

    it = loader.train_loader(records, bad, 2, MEAN, STD)
    with pytest.raises(ValueError, match="no frames"):
        next(it)
    it.close()
    mine, _ = _mappers(0)
    it = loader.train_loader(records, mine, 1, MEAN, STD, prefetch=1)
    next(it)
    it.close()
    assert not it._thread.is_alive()


@pytest.mark.parametrize("case", [
    dict(rate=1.0), dict(rate=0.5), dict(rate=1.0, random_num=True),
    dict(rate=1.0, densify_sparse=True), dict(rate=1.0, min_ratio=0.3, max_ratio=0.6),
])
def test_apply_clip_copy_paste_matches_jax(records, case):
    mine_m, _ = _mappers(17)
    samples = [mine_m(r) for r in records]
    pasted = 0
    for seed in range(4):
        got = copy_paste.apply_clip_copy_paste(samples, np.random.RandomState(seed), **case)
        want = jax_cp.apply_clip_copy_paste(samples, np.random.RandomState(seed), **case)
        for g, w, s in zip(got, want, samples):
            for key in ("masks", "valid", "labels"):
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            np.testing.assert_allclose(g["image"], w["image"], rtol=0, atol=1e-3)
            pasted += g["image"] is not s["image"]
    if not case.get("densify_sparse"):
        assert pasted  # the seeds paste
