"""The KD step's options in the port against the JAX package, on the CPU,
module by module: `warp_masks_affine` (the disentangled view's target
warp), the train mapper's two views and their affines, `collate_clips`
with the distillation view and bit-packed targets, `choose_lattice`,
`lattice_sample` / `lattice_coords`, `distillation_nms`, and a polygon
annotation without cv2. (tests/test_torch_train_option_steps.py holds
whole steps to JAX's.)

Tolerances, and why:
  * warp: exact (bool and bilinear values) on integer translations and
    flips, where every weight is 0 or 1; on a scaled affine the bilinear
    values within 1e-5 (the inverse and the projective divide round in
    f32 in another order), and a pixel may flip only where JAX's value
    lies within 1e-5 of the 0.5 threshold;
  * the mapper: frame selection, masks, valid, labels and affines
    identical; images within 0.02 after normalization (the port's own
    resize and warp arithmetic is OpenCV 5.0's, as tests/test_torch_data_train.py);
  * `choose_lattice` and `distillation_nms`: exact (pure Python choices and
    hard decisions);
  * `lattice_sample`: the same blends op for op, held at 1e-6 absolute in
    f32 (measured: 0); against `grid_sample_rows` at `lattice_coords`,
    2e-5 (another rounding of the coordinates).
"""
import json
import math

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

from s2d_tpu.data import loader as jax_loader
from s2d_tpu.data import mapper as jax_mapper
from s2d_tpu.data import rle as jax_rle
from s2d_tpu.data import ytvis as jax_ytvis
from s2d_tpu.data.augment import ClipAugConfig as JaxAugConfig
from s2d_tpu.ops import lattice as jax_lattice
from s2d_tpu.ops.warp import warp_masks_affine as jax_warp
from s2d_tpu.train import distillation_nms as jax_distillation_nms

from s2d_tpu_torch.data import loader, mapper, ytvis
from s2d_tpu_torch.data.augment import ClipAugConfig
from s2d_tpu_torch.ops import lattice
from s2d_tpu_torch.ops.sampling import grid_sample_rows
from s2d_tpu_torch.ops.warp import warp_masks_affine
from s2d_tpu_torch.train import trainer

MEAN = (123.675, 116.280, 103.530)
STD = (58.395, 57.120, 57.375)


# ------------------------------------------------------------------ warp


def _ellipses(rng, b, n, t, h, w):
    yy, xx = np.mgrid[:h, :w]
    cy = rng.uniform(0, h, (b, n, t, 1, 1))
    cx = rng.uniform(0, w, (b, n, t, 1, 1))
    r = rng.uniform(3, 12, (b, n, 1, 1, 1))
    return ((yy - cy) / r) ** 2 + ((xx - cx) / (1.5 * r)) ** 2 < 1


def _affines(kind, b, t, h, w, rng):
    aff = np.tile(np.eye(3), (b, t, 1, 1))
    for bi in range(b):
        for ti in range(t):
            if kind == "translate":  # parts move out of the frame
                aff[bi, ti, :2, 2] = rng.randint(-9, 10, 2)
            elif kind == "flip":
                aff[bi, ti, 0, :] = [-1, 0, w - 1 - rng.randint(0, 3)]
            else:  # scaled about a point, rotated a little
                s, a = rng.uniform(0.8, 1.3), rng.uniform(-0.2, 0.2)
                aff[bi, ti, :2, :2] = s * np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
                aff[bi, ti, :2, 2] = rng.uniform(-6, 6, 2)
    return aff.astype(np.float32)


@pytest.mark.parametrize("kind", ["translate", "flip", "scaled"])
def test_warp_masks_affine_matches_jax(kind):
    """Zeros outside the frame and the 0.5 threshold, as JAX's grid_sample."""
    rng = np.random.RandomState({"translate": 0, "flip": 1, "scaled": 2}[kind])
    b, n, t, h, w = 2, 3, 2, 40, 56
    masks = _ellipses(rng, b, n, t, h, w)
    aff = _affines(kind, b, t, h, w, rng)
    # eager: under jit XLA's fused f32 inverse leaves integer coordinates
    # 1e-6 off, and the 0/1 weights 4e-6 off with them
    ref_v = np.asarray(jax_warp(jnp.asarray(masks), jnp.asarray(aff), binarize=False))
    ref = np.asarray(jax_warp(jnp.asarray(masks), jnp.asarray(aff)))
    got_v = warp_masks_affine(torch.from_numpy(masks), torch.from_numpy(aff), binarize=False).numpy()
    got = warp_masks_affine(torch.from_numpy(masks), torch.from_numpy(aff)).numpy()
    assert got.dtype == bool and ref.sum() > 100
    if kind == "scaled":
        np.testing.assert_allclose(got_v, ref_v, rtol=0, atol=1e-5)
        flips = got != ref
        assert (np.abs(ref_v[flips] - 0.5) < 1e-5).all(), int(flips.sum())
        assert (0.0 < ref_v).sum() > (ref_v == 1.0).sum()  # really interpolated
    else:
        np.testing.assert_array_equal(got_v, ref_v)
        np.testing.assert_array_equal(got, ref)
    if kind == "translate":
        shifted = aff[0, 0, :2, 2].astype(int)
        want = np.zeros_like(masks[0, :, 0])
        src = masks[0, :, 0]
        dx, dy = shifted
        ys, yd = slice(max(0, -dy), h - max(0, dy)), slice(max(0, dy), h - max(0, -dy))
        xs, xd = slice(max(0, -dx), w - max(0, dx)), slice(max(0, dx), w - max(0, -dx))
        want[:, yd, xd] = src[:, ys, xs]
        np.testing.assert_array_equal(got[0, :, 0], want)


# ------------------------------------------------------------------ mapper and collate

H, W, LENGTH = 72, 104, 8
DATASET = "tiny_torch_options"


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A YTVIS train set of PNG frames, 3 videos, instances annotated on
    windows of frames, registered in both packages."""
    root = tmp_path_factory.mktemp("options_data")
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[:H, :W]
    videos, annotations = [], []
    for vid in (1, 2, 3):
        files = [f"v{vid}/{i:05d}.png" for i in range(LENGTH)]
        (root / f"v{vid}").mkdir()
        for name in files:
            cv2.imwrite(str(root / name), rng.randint(0, 256, (H, W, 3), np.uint8))
        videos.append({"id": vid, "file_names": files, "height": H, "width": W, "length": LENGTH})
        for j in range(3):
            lo = rng.randint(0, 4)
            cy, cx = rng.uniform(0.3, 0.7) * H, rng.uniform(0.3, 0.7) * W
            segs = [jax_rle.encode(((yy - cy - i) / 12) ** 2 + ((xx - cx + i) / 16) ** 2 < 1)
                    if lo <= i < lo + 5 else None for i in range(LENGTH)]
            annotations.append({"id": 10 * vid + j, "video_id": vid, "category_id": 1,
                                "segmentations": segs, "iscrowd": 0})
    path = root / "train.json"
    path.write_text(json.dumps({"videos": videos, "annotations": annotations,
                                "categories": [{"id": 1, "name": "a"}]}))
    jax_ytvis.register_ytvis(DATASET, str(path), str(root))
    ytvis.register_ytvis(DATASET, str(path), str(root))
    return ytvis.get_dataset(DATASET)[0]


def _mappers(seed):
    aug = dict(min_sizes=(48, 64), max_size=1333, crop_enabled=True, crop_range=(40, 64),
               brightness=True, contrast=True, rotation=True)
    mine = mapper.ClipMapper(mapper.MapperConfig(sampling_frame_num=3, max_instances=5,
                                                 disentangle=True, aug=ClipAugConfig(**aug)),
                             seed=seed)
    theirs = jax_mapper.ClipMapper(
        jax_mapper.MapperConfig(sampling_frame_num=3, max_instances=5, disentangle=True,
                                aug=JaxAugConfig(**aug)), seed=seed)
    return mine, theirs


@pytest.mark.parametrize("seed", [0, 1])
def test_mapper_two_views_match_jax(records, seed):
    """Both views drawn in JAX's order from one RandomState: the same
    frames, masks, affines D P^-1 and canvases; the second view differs
    from the first."""
    mine, theirs = _mappers(seed)
    std = np.asarray(STD, np.float32)
    differ = 0
    for record in records * 2:
        got, want = mine(record), theirs(record)
        assert set(got) == set(want)
        assert got["selected_idx"] == [int(i) for i in want["selected_idx"]]
        for key in ("masks", "valid", "labels"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["distill_affine"].dtype == np.float32
        np.testing.assert_array_equal(got["distill_affine"], want["distill_affine"])
        for key in ("image", "distill_image"):
            assert got[key].shape == want[key].shape and got[key].dtype == np.float32
            np.testing.assert_allclose(got[key] / std, want[key] / std, rtol=0, atol=0.02,
                                       err_msg=key)
        differ += got["image"].shape != got["distill_image"].shape or not np.allclose(
            got["image"], got["distill_image"])
    assert differ


def test_collate_with_distill_and_packed_targets_matches_jax(records):
    """The canvas holds both views; images, packed masks, valid, the
    distillation images and affines equal JAX's collate_clips."""
    mine, _ = _mappers(4)
    samples = [mine(r) for r in records]
    sizes = {s["distill_image"].shape[1:3] for s in samples} | {s["image"].shape[1:3] for s in samples}
    assert len(sizes) > 1
    for pack in (True, False):
        got = loader.collate_clips(samples, MEAN, STD, pack_masks=pack)
        want = jax_loader.collate_clips(samples, MEAN, STD, pack_masks=pack)
        assert set(got) == set(want) == {"images", "masks", "valid", "distill_images",
                                         "distill_affine"}
        for key in got:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["images"].shape[2:4] == got["distill_images"].shape[2:4]
    assert packed_width(loader.collate_clips(samples, MEAN, STD, pack_masks=True)) * 8 == \
        got["images"].shape[3]


def packed_width(batch):
    assert batch["masks"].dtype == np.uint8
    return batch["masks"].shape[-1]


# ------------------------------------------------------------------ lattice


def test_choose_lattice_matches_jax():
    """The KD config's pools (160,000 points x 3 and the matcher's 160,000)
    at the canvases its loader makes, the tiny tests' pools, and a grid of
    sizes: the same (Ly, Lx)."""
    cases = []
    for hp, wp in ((384, 640), (448, 768), (512, 896), (384, 704), (32, 32), (64, 96)):
        for count in (480000, 160000, 12544, 192):
            cases.append((count, (hp // 4, hp), (wp // 4, wp)))
    rng = np.random.RandomState(0)
    for _ in range(40):
        h, w = 32 * rng.randint(1, 12), 32 * rng.randint(1, 12)
        cases.append((int(rng.randint(50, 20000)), (h // 4, h), (w // 4, w)))
    for count, hs, ws in cases:
        assert lattice.choose_lattice(count, hs, ws) == jax_lattice.choose_lattice(count, hs, ws)
    assert lattice.valid_axis_counts((96, 384)) == jax_lattice.valid_axis_counts((96, 384))


@pytest.mark.parametrize("phase", [0.0, 1 - 1e-7, 0.37])
@pytest.mark.parametrize("ly,lx", [(16, 36), (4, 6), (24, 3)])  # up, down, mixed (from 8 x 12)
def test_lattice_sample_matches_jax(phase, ly, lx):
    """Phases at 0 and just below 1, where a lattice point reaches the
    border half a pixel out (zeros outside), upsampling and downsampling
    axes; then `grid_sample_rows` at `lattice_coords`, the gather it
    equals."""
    maps = np.random.RandomState(1).randn(3, 8, 12).astype(np.float32)
    ph = np.array([phase, 1 - phase if phase else phase], np.float32)
    sample = jax.jit(jax_lattice.lattice_sample, static_argnums=(1, 2))
    ref = np.asarray(sample(jnp.asarray(maps), ly, lx, jnp.asarray(ph)))
    got = lattice.lattice_sample(torch.from_numpy(maps), ly, lx, torch.from_numpy(ph))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    coords = lattice.lattice_coords(ly, lx, torch.from_numpy(ph))
    np.testing.assert_allclose(coords.numpy(), np.asarray(jax_lattice.lattice_coords(ly, lx, ph)),
                               rtol=0, atol=1e-7)
    rows = torch.from_numpy(maps).reshape(3, -1).T[None]
    gathered = grid_sample_rows(rows, (2 * coords - 1)[None], 8, 12)[0].T.reshape(3, ly, lx)
    np.testing.assert_allclose(gathered.numpy(), ref, rtol=0, atol=2e-5)


def test_criterion_pair_lattice_matches_jax():
    """The criterion pair in lattice mode on one set of predictions against
    JAX's, with JAX's phases and Bernoulli draws: a pool of 73,728 points,
    so that the uncertainty threshold counts on a strided subsample whose
    stride is coprime with Lx (the rule for pools of 8192 or more). f32:
    losses within rtol 1e-5 (measured ~2e-7)."""
    from s2d_tpu.losses import criterion as jax_criterion

    from s2d_tpu_torch.losses import criterion

    rng = np.random.RandomState(0)
    b, q, t, hp, wp = 1, 6, 2, 8, 12
    mk = lambda: (rng.randn(b, q, 2).astype(np.float32),  # noqa: E731
                  (3 * rng.randn(b, q, t, hp, wp)).astype(np.float32))
    layers = [mk() for _ in range(2)]
    sup_m, sup_v = rng.rand(b, 4, t, 32, 48) > 0.6, np.array([[1, 0, 1, 1]], bool)
    kd_m, kd_v = rng.rand(b, q, t, 32, 48) > 0.6, rng.rand(b, q) > 0.4
    case = dict(num_points=25000, oversample_ratio=3.0, importance_sample_ratio=0.75)
    ly, lx = lattice.choose_lattice(75000, (hp, 32), (wp, 48))
    s = ly * lx
    stride = s // 32768
    while math.gcd(stride, lx) != 1:
        stride += 1
    assert stride > 2 and s >= 65536
    key = jax.random.PRNGKey(3)
    _, k_pool, k_bern = jax.random.split(key, 3)
    num_random = 25000 - int(0.75 * 25000)
    draws = {"phases": torch.from_numpy(np.array(jax.random.uniform(k_pool, (2, 2)))),
             "bern": {r: torch.from_numpy(np.array(jax.random.uniform(k_bern, (r, s))
                                                   < num_random / s)) for r in (8, 12)}}

    def outputs(lib):
        return {"pred_logits": lib(layers[1][0]), "pred_masks": lib(layers[1][1]),
                "aux_pred_logits": [lib(layers[0][0])], "aux_pred_masks": [lib(layers[0][1])]}

    jcfg = jax_criterion.CriterionConfig(**case, point_sampling="lattice")
    jo = outputs(jnp.asarray)
    pair = jax.jit(lambda o, sm, sv, km, kv: jax_criterion.set_criterion_pair(
        key, o, sm, sv, jcfg, key, o, km, kv, jcfg))
    ref = pair(jo, jnp.asarray(sup_m), jnp.asarray(sup_v), jnp.asarray(kd_m), jnp.asarray(kd_v))
    pcfg = criterion.CriterionConfig(**case, point_sampling="lattice", assign_impl="plain")
    got = criterion.set_criterion_pair(
        outputs(torch.from_numpy), torch.from_numpy(sup_m), torch.from_numpy(sup_v), pcfg,
        torch.from_numpy(kd_m), torch.from_numpy(kd_v), pcfg, draws=draws)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            np.testing.assert_allclose(float(g[k]), float(r[k]), rtol=1e-5, atol=1e-7, err_msg=k)


# ------------------------------------------------------------------ distillation NMS


def test_distillation_nms_matches_jax():
    """Exact validity, with equal scores (stable order), invalid candidates
    that would suppress a valid one if they took part, and a clip with no
    valid candidate."""
    b, q, t, h, w = 3, 8, 2, 16, 20
    rng = np.random.RandomState(5)
    base = _ellipses(rng, b, q, t, h, w)
    base[:, 1] = base[:, 0]  # a copy of 0
    base[:, 5] = np.roll(base[:, 4], 1, axis=-1)  # overlaps 4
    base[:, 7] = base[:, 6]
    logits = rng.randn(b, q, 2).astype(np.float32)
    logits[:, 6] = logits[:, 7] = [2.0, 0.0]  # equal scores: 6 visits first
    logits[:, 0] = [3.0, 0.0]  # the highest score, invalid in clip 0
    valid = rng.rand(b, q) > 0.2
    valid[0, 0], valid[0, 1] = False, True  # 0 would suppress 1
    valid[:, 6] = valid[:, 7] = True
    valid[2] = False  # no valid candidate
    for thr in (0.5, 0.75):
        ref = np.asarray(jax_distillation_nms(jnp.asarray(base), {"pred_logits": jnp.asarray(logits)},
                                              jnp.asarray(valid), thr))
        for impl in ("plain", "kernel"):  # a CPU tensor takes the plain loop either way
            got = trainer.distillation_nms(torch.from_numpy(base),
                                           {"pred_logits": torch.from_numpy(logits)},
                                           torch.from_numpy(valid), thr, impl)
            np.testing.assert_array_equal(got.numpy(), ref)
        assert not ref[2].any() and not ref[:, 7].any()
    # at 0.75: the invalid 0 suppressed nothing, of the tie 6 survived
    assert ref[0, 1] and not ref[0, 0] and ref[:2, 6].all() and ref[1, 0] and not ref[1, 1]


def test_polygons_without_cv2_raise(monkeypatch):
    """A polygon segmentation no longer needs cv2: without it (the card's
    machine) the port's native fill gives cv2.fillPoly's mask, and nothing
    raises."""
    import sys

    import cv2

    from s2d_tpu_torch.data import rle

    poly = [[1.0, 1.0, 6.0, 1.0, 6.0, 6.0]]
    ref = np.zeros((8, 8), np.uint8)
    cv2.fillPoly(ref, [np.asarray(poly[0], np.int32).reshape(-1, 2)], 1)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(rle.polygons_to_mask(poly, 8, 8), ref.astype(bool))
