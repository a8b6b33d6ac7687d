"""The port's polygon fill (`native/rle_ops.cpp` poly_fill, through
`data/rle.polygons_to_mask`) against `cv2.fillPoly` and JAX's
`s2d_tpu.data.rle.polygons_to_mask`, which calls it.

Tolerance: exact, pixel for pixel, on a fixed list of hard cases (overlaps,
holes, self-intersections, collinear and repeated points, zero area, points
outside the image, coordinates that round half to even, parts too short to
keep), on hypothesis examples (at most 150, images at most 64x64) and on one
480x640 polygon of 100 vertices. The port's fill runs whether or not cv2 is
installed; the last test blocks cv2 to show it.
"""
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import cv2

from s2d_tpu.data import rle as jax_rle

from s2d_tpu_torch.data import rle


def cv2_fill(polygons, h, w):
    """What JAX's function does, written out: round half to even, int32,
    parts of 6 numbers or more, one cv2.fillPoly call."""
    mask = np.zeros((h, w), np.uint8)
    pts = [np.round(np.asarray(p, np.float64).reshape(-1, 2)).astype(np.int32)
           for p in polygons if len(p) >= 6]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask.astype(bool)


def check(polygons, h, w):
    got = rle.polygons_to_mask(polygons, h, w)
    assert got.dtype == bool and got.shape == (h, w)
    np.testing.assert_array_equal(got, cv2_fill(polygons, h, w))
    np.testing.assert_array_equal(got, jax_rle.polygons_to_mask(polygons, h, w))


HARD = {
    "triangle": ([[2, 3, 20.5, 4, 11, 17.9]], 20, 24),
    "half_to_even": ([[0.5, 0.5, 10.5, 1.5, 3.5, 9.5, 2.5, 12.5]], 16, 16),
    "concave": ([[1, 1, 14, 1, 14, 14, 8, 5, 1, 14]], 16, 16),
    "bowtie": ([[1, 1, 14, 14, 14, 1, 1, 14]], 16, 16),
    "pentagram": ([[8, 0, 13, 15, 0, 5, 16, 5, 3, 15]], 17, 17),
    "collinear": ([[1, 1, 5, 5, 9, 9, 13, 13]], 16, 16),
    "collinear_with_area": ([[1, 1, 8, 1, 15, 1, 15, 9, 1, 9]], 12, 17),
    "repeated_points": ([[3, 3, 3, 3, 12, 4, 12, 4, 12, 4, 6, 13]], 16, 16),
    "one_point": ([[5, 5, 5, 5, 5, 5]], 10, 10),
    "horizontal_line": ([[1, 4, 9, 4, 5, 4]], 10, 10),
    "vertical_line": ([[4, 1, 4, 9, 4, 5]], 10, 10),
    "overlapping_parts": ([[1, 1, 12, 2, 6, 12], [4, 4, 15, 5, 9, 15]], 17, 17),
    "nested_parts": ([[0, 0, 20, 0, 20, 20, 0, 20], [5, 5, 15, 5, 15, 15, 5, 15]], 22, 22),
    "same_part_twice": ([[2, 2, 12, 3, 7, 11]] * 2, 14, 14),
    "short_parts_dropped": ([[1, 1, 2, 1], [3, 3, 9, 3, 6, 8], [1.0, 2.0, 3.0, 4.0]], 10, 10),
    "only_short_parts": ([[1, 1, 2, 1]], 6, 6),
    "partly_outside": ([[-6, 2, 9, 5, -6, 12]], 14, 8),
    "outside_every_side": ([[-30, -20, 50, -10, 60, 40, -10, 70]], 24, 32),
    "wholly_outside": ([[40, 40, 60, 45, 50, 60]], 20, 20),
    "outside_touching_a_corner": ([[1, 2, 10, -1, 4, 1]], 2, 5),
    "huge_coordinates": ([[-100000, 5, 100000, 7, 3, 100000]], 30, 40),
    "thin_sliver": ([[0, 0, 31, 1, 31, 2]], 8, 32),
    "one_pixel_image": ([[0, 0, 0, 0, 0, 0]], 1, 1),
    "one_column_image": ([[-1, 20, -1, 18, 2, 17, 1, 17]], 37, 1),
}


@pytest.mark.parametrize("case", sorted(HARD))
def test_hard_cases_equal_cv2_and_jax(case):
    check(*HARD[case])


coord = st.floats(-24.0, 88.0, allow_nan=False).map(lambda v: round(v * 2) / 2)
part = st.lists(st.tuples(coord, coord), min_size=1, max_size=12).map(
    lambda pts: [c for xy in pts for c in xy])


@settings(max_examples=150, deadline=None, derandomize=True)
@given(polygons=st.lists(part, min_size=1, max_size=4), h=st.integers(1, 64),
       w=st.integers(1, 64))
def test_random_polygons_equal_cv2_and_jax(polygons, h, w):
    check(polygons, h, w)


def test_a_100_vertex_polygon_at_480x640():
    rng = np.random.RandomState(0)
    angles = np.sort(rng.uniform(0, 2 * np.pi, 100))
    radius = rng.uniform(40, 300, 100)
    poly = np.stack([320 + radius * np.cos(angles), 240 + radius * np.sin(angles)], 1)
    check([poly.reshape(-1).tolist()], 480, 640)


def test_fill_needs_no_cv2(monkeypatch):
    polygons, h, w = HARD["overlapping_parts"]
    want = cv2_fill(polygons, h, w)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(rle.polygons_to_mask(polygons, h, w), want)
