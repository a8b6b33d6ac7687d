"""The port's cv2-free transforms (`s2d_tpu_torch/data/transforms.py`)
against cv2 on the CPU, on seeded random inputs: sizes from 1x1 to
720x1280, odd and even, scales up and down (integer and not), rotations
in [-15, 15] degrees about centres anywhere in the image, uint8 and float32
frames, bool and uint8 masks.

Tolerances, set before the measurement from what each route computes:
  * nearest resizes and warps of masks, the rotation matrix, uint8 bilinear
    resizes and float32 bilinear warps: identical (the transforms reproduce
    cv2's arithmetic, see the module docstring);
  * float32 bilinear resizes: 1e-3 on the 0-255 scale (coordinates rounded
    differently from cv2's).

The exact cases hold for OpenCV 5, whose arithmetic the module reproduces.
Its warpAffine rounds the coordinates of the columns past its last full
vector differently, so the warp tests set `transforms.CV_LANES` to the
float lanes of the code this cv2 dispatches (AVX-512: 16, as the module's
default; AVX2: 8; else 4). Another major version (OpenCV 4 warps in fixed
point, AB_BITS 10 with 1/32-pixel tables) is not reproduced: there the
uint8 resizes are held to 1 grey level, identical on 99.9% of pixels, and
the warp tests skip.
"""
import numpy as np
import pytest

import cv2

from s2d_tpu_torch.data import transforms


def _cv2_warp_lanes():
    """The float32 lanes of cv2's warpAffine vector loop: OpenCV 5 runs the
    widest code its build dispatches and the CPU supports. None for another
    major version."""
    if cv2.__version__.split(".")[0] != "5":
        return None
    features = cv2.getCPUFeaturesLine().replace("*", "").split()
    for name, feature_id, lanes in (("AVX512-SKX", 256, 16), ("AVX2", 11, 8)):
        if name in features and cv2.checkHardwareSupport(feature_id):
            return lanes
    return 4


CV_WARP_LANES = _cv2_warp_lanes()


def _assert_uint8_resize(got, want):
    if CV_WARP_LANES is not None:
        np.testing.assert_array_equal(got, want)
        return
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape and diff.max() <= 1 and (diff == 0).mean() >= 0.999

# (h, w) of the source, (h, w) of the resize
RESIZES = [
    ((1, 1), (1, 1)), ((1, 1), (5, 3)), ((7, 1), (1, 9)), ((3, 5), (6, 10)),
    ((17, 29), (51, 87)), ((33, 65), (11, 13)), ((64, 96), (32, 48)), ((101, 77), (160, 123)),
    ((360, 640), (720, 1280)), ((719, 1279), (480, 853)), ((720, 1280), (360, 640)),
    ((600, 700), (411, 480)),
]
WARPS = [(1, 1), (2, 3), (15, 17), (33, 16), (64, 96), (127, 255), (481, 641), (720, 1280)]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_uint8_and_masks(src, dst):
    rng = np.random.RandomState(src[0] * 1000 + dst[1])
    for channels in ((3,), ()):
        img = rng.randint(0, 256, src + channels).astype(np.uint8)
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
        _assert_uint8_resize(transforms.resize_linear(img, dst), want)
    masks = rng.rand(3, *src) > 0.5
    got = transforms.resize_nearest(masks, dst)
    for m, g in zip(masks, got):
        want = cv2.resize(m.astype(np.uint8), dst[::-1], interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(g, want.astype(bool))


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_float32(src, dst):
    rng = np.random.RandomState(src[1] * 1000 + dst[0])
    img = (rng.rand(*src, 3) * 255).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR).reshape(*dst, 3)
    got = transforms.resize_linear(img, dst)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("hw", WARPS)
def test_rotation_warp(hw, monkeypatch):
    if CV_WARP_LANES is None:
        pytest.skip(f"OpenCV {cv2.__version__}: its warpAffine arithmetic is not reproduced")
    monkeypatch.setattr(transforms, "CV_LANES", CV_WARP_LANES)
    h, w = hw
    rng = np.random.RandomState(h * 7919 + w)
    for _ in range(2):
        angle = rng.uniform(-15.0, 15.0)
        center = (rng.uniform(-0.2, 1.2) * w, rng.uniform(-0.2, 1.2) * h)
        mat = transforms.rotation_matrix_2d(center, angle, 1.0)
        np.testing.assert_array_equal(mat, cv2.getRotationMatrix2D(center, angle, 1.0))
        img = (rng.rand(h, w, 3) * 255).astype(np.float32)
        want = cv2.warpAffine(img, mat, (w, h), flags=cv2.INTER_LINEAR).reshape(h, w, 3)
        np.testing.assert_array_equal(transforms.warp_affine(img, mat), want)
        mask = rng.rand(h, w) > 0.5
        want = cv2.warpAffine(mask.astype(np.uint8), mat, (w, h), flags=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(transforms.warp_affine(mask.astype(np.uint8), mat), want)
        np.testing.assert_array_equal(transforms.warp_affine(mask, mat), want.astype(bool))
        # a stack of masks as channels, as the augmentation warps them
        stack = rng.rand(h, w, 4) > 0.5
        got = transforms.warp_affine(stack, mat)
        for c in range(4):
            want = cv2.warpAffine(stack[..., c].astype(np.uint8), mat, (w, h),
                                  flags=cv2.INTER_NEAREST)
            np.testing.assert_array_equal(got[..., c], want.astype(bool))


def test_bad_dtypes_raise():
    with pytest.raises(TypeError):
        transforms.resize_linear(np.zeros((4, 4), np.float64), (2, 2))
    with pytest.raises(TypeError):
        transforms.warp_affine(np.zeros((4, 4), np.int32), np.eye(2, 3))
