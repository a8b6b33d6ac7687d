"""The image transforms of the train data path, without cv2: the port's own
versions of the cv2 calls that `s2d_tpu/data/augment.py` and
`s2d_tpu/data/copy_paste.py` make (`cv2.resize`, `cv2.getRotationMatrix2D`,
`cv2.warpAffine`), in numpy on the loader thread.

Each reproduces the arithmetic of the OpenCV 5.0 build it is tested
against (`tests/test_torch_transforms.py`), not only its geometry:

  * `resize_linear` on uint8 (INTER_LINEAR): source coordinates in float32
    ((d + 0.5) * src / dst - 0.5), 11-bit fixed-point weights; the
    horizontal pass clamps both the index and the weight at the border, the
    vertical pass clamps only the row index (the weights stay as computed);
    the vertical sum is the SIMD one, ((b0 * (S0 >> 4)) >> 16) +
    ((b1 * (S1 >> 4)) >> 16) + 2 >> 2, which OpenCV 5 applies to every
    column. Identical to cv2 on every input tested.
  * `resize_linear` on float32: the same geometry with the coordinates in
    float64 and fused multiply-adds; not bit-exact (the tests hold it to
    1e-3 of cv2 on the 0-255 scale).
  * `resize_nearest` (INTER_NEAREST): floor(d * (1 / (dst / src))), clamped.
  * `warp_affine` (dsize = the input's, constant-0 border): the matrix
    inverted in float64 as cv2 does and held in float32; source coordinates
    as cv2's vector loop computes them, fma(M0, x, M1 * y + M2), except in
    the columns past the last full vector of `CV_LANES` floats, where its
    scalar loop computes fma(M0, x, M1 * y) + M2. Bilinear on float32
    (lerps by fused multiply-add, out-of-image taps 0), nearest on uint8 and
    bool (round half to even). Identical to cv2 on every input tested.

OpenCV 5's warpAffine no longer takes the fixed-point path (AB_BITS 10 and
1/32-pixel interpolation tables) of OpenCV 4: its coordinates and weights
are float32, which is what this module reproduces.

A fused multiply-add of float32 operands is computed in float64 (the
product is exact there) and rounded to float32 once more: this double
rounding can differ from a true fma in the last bit, rarely.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

COEF_BITS = 11  # INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS
# f32 lanes of the vector loop of OpenCV 5's warpAffine in its AVX-512 code
# (8 in its AVX2 code, which the tests set where cv2 dispatches that):
# columns at and past (W // CV_LANES) * CV_LANES take its scalar loop, whose
# coordinates round differently (taking 8 lanes for 16 moves the tests'
# float32 warps of noise frames by up to 3.6e-3 grey levels)
CV_LANES = 16


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding of the exact product."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _linear_taps(src: int, dst: int, clamp_weights: bool, f64: bool):
    """Per output index: the two source indices and the two weights."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    if not f64:
        pos = pos.astype(np.float32)
    lo = np.floor(pos).astype(np.int64)
    frac = (pos - lo).astype(np.float32)
    if clamp_weights:
        frac[lo < 0] = 0.0
        frac[lo >= src - 1] = 0.0
    i0 = np.clip(lo, 0, src - 1)
    i1 = np.clip(lo + 1, 0, src - 1)
    return i0, i1, (np.float32(1.0) - frac).astype(np.float32), frac


def _resize_u8(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    h, w = img.shape[:2]
    x0, x1, ax0, ax1 = _linear_taps(w, dw, True, False)
    y0, y1, ay0, ay1 = _linear_taps(h, dh, False, False)
    ax0, ax1 = (np.rint(a * COEF_SCALE).astype(np.int64) for a in (ax0, ax1))
    ay0, ay1 = (np.rint(a * COEF_SCALE).astype(np.int64) for a in (ay0, ay1))
    extra = (None,) * (img.ndim - 2)
    src = img.astype(np.int64)
    rows = src[:, x0] * ax0[(slice(None),) + extra] + src[:, x1] * ax1[(slice(None),) + extra]
    b0 = ay0[(slice(None), None) + extra]
    b1 = ay1[(slice(None), None) + extra]
    out = (((b0 * (rows[y0] >> 4)) >> 16) + ((b1 * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _resize_f32(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    h, w = img.shape[:2]
    x0, x1, ax0, ax1 = _linear_taps(w, dw, True, True)
    y0, y1, ay0, ay1 = _linear_taps(h, dh, False, True)
    extra = (None,) * (img.ndim - 2)
    a0, a1 = ax0[(slice(None),) + extra], ax1[(slice(None),) + extra]
    rows = _fma(img[:, x1], a1, (img[:, x0] * a0).astype(np.float32))
    b0, b1 = ay0[(slice(None), None) + extra], ay1[(slice(None), None) + extra]
    return _fma(rows[y1], b1, (rows[y0] * b0).astype(np.float32))


def resize_linear(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=INTER_LINEAR) of an (H, W) or
    (H, W, C) uint8 or float32 image."""
    dh, dw = int(size_hw[0]), int(size_hw[1])
    if img.dtype == np.uint8:
        return _resize_u8(img, dh, dw)
    if img.dtype == np.float32:
        return _resize_f32(img, dh, dw)
    raise TypeError(f"resize_linear takes uint8 or float32, not {img.dtype}")


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """The source index of each of `dst` outputs under INTER_NEAREST."""
    step = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * step).astype(np.int64), src - 1)


def resize_nearest(mask: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(mask, (W, H), interpolation=INTER_NEAREST) over the LAST
    two axes of a bool or uint8 array of any leading shape."""
    h, w = mask.shape[-2:]
    rows = _nearest_index(h, int(size_hw[0]))
    cols = _nearest_index(w, int(size_hw[1]))
    return mask[..., rows[:, None], cols[None, :]]


def rotation_matrix_2d(center: Sequence[float], angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) float64, `angle` in degrees,
    counter-clockwise about `center` (x, y), which cv2 takes as float32."""
    rad = angle * (math.pi / 180.0)
    alpha = math.cos(rad) * scale
    beta = math.sin(rad) * scale
    cx, cy = (float(np.float32(c)) for c in center)
    return np.array([[alpha, beta, (1.0 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1.0 - alpha) * cy]], np.float64)


def _invert_affine(mat: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform's float64 arithmetic, in its order."""
    m = [float(v) for v in np.asarray(mat, np.float64).reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    return np.asarray(m, np.float64).astype(np.float32)


def _source_coords(mat: np.ndarray, h: int, w: int):
    """float32 source (x, y) of every output pixel, as cv2 computes them."""
    m = _invert_affine(mat)
    y, x = np.mgrid[:h, :w].astype(np.float32)
    scalar = x >= (w // CV_LANES) * CV_LANES

    def axis(m0, m1, m2):
        m1y = (m1 * y).astype(np.float32)
        vector = _fma(m0, x, (m1y + m2).astype(np.float32))
        tail = (_fma(m0, x, m1y) + m2).astype(np.float32)
        return np.where(scalar, tail, vector)

    return axis(m[0], m[1], m[2]), axis(m[3], m[4], m[5])


def warp_affine(img: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """cv2.warpAffine(img, mat, (W, H), borderValue=0): bilinear for an
    (H, W) or (H, W, C) float32 image, nearest for a uint8 or bool one (the
    output keeps the input's dtype). `mat` maps source to output pixels."""
    h, w = img.shape[:2]
    sx, sy = _source_coords(mat, h, w)
    if img.dtype == np.float32:
        return _warp_bilinear(img, sx, sy)
    if img.dtype in (np.uint8, np.bool_):
        ix, iy = np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64)
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        got = img[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)]
        inside = inside.reshape(inside.shape + (1,) * (img.ndim - 2))
        return np.where(inside, got, np.zeros((), img.dtype))
    raise TypeError(f"warp_affine takes float32, uint8 or bool, not {img.dtype}")


def _warp_bilinear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    extra = (None,) * (img.ndim - 2)
    fx = (sx - x0.astype(np.float32)).astype(np.float32)[(Ellipsis,) + extra]
    fy = (sy - y0.astype(np.float32)).astype(np.float32)[(Ellipsis,) + extra]
    # two pixels of zeros around the image: every tap outside reads 0
    x0 = np.clip(x0, -2, w + 1) + 2
    y0 = np.clip(y0, -2, h + 1) + 2
    padded = np.pad(img, ((2, 3), (2, 3)) + ((0, 0),) * (img.ndim - 2))
    p00, p01 = padded[y0, x0], padded[y0, x0 + 1]
    p10, p11 = padded[y0 + 1, x0], padded[y0 + 1, x0 + 1]
    top = _fma(fx, (p01 - p00).astype(np.float32), p00)
    bottom = _fma(fx, (p11 - p10).astype(np.float32), p10)
    return _fma(fy, (bottom - top).astype(np.float32), top)
