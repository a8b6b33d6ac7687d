"""COCO-compatible RLE mask codec: the port's copy of `s2d_tpu/data/rle.py`.

pycocotools is not a dependency; the YTVIS annotation format (per-frame
`segmentation` as compressed RLE dicts or polygon lists) and `results.json`
need encode/decode, so the codec is implemented here:

  * counts are column-major (Fortran order) run lengths, starting with the
    number of leading zeros
  * the compressed "counts" string is the COCO variable-length base-32
    signed encoding with difference coding from the 3rd element on
    (chars '0'..'o' = value + 48, 5 value bits + 1 continuation bit)

The hot loops go to the port's own C++ library (`s2d_tpu_torch/native`);
without it (no g++) each function takes its numpy path below, which is
also the twin the tests hold the native path to. tests/test_torch_eval.py
holds both routes bit-identical to `s2d_tpu.data.rle`.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from .. import native as _native

RLE = Dict[str, Union[List[int], str, bytes]]


def rle_counts(r: RLE) -> np.ndarray:
    """RLE dict -> int64 run counts (decoding the string form if needed)."""
    counts = r["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return np.asarray(counts, np.int64)


def mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """(H, W) binary mask -> run-length counts (column-major)."""
    native_counts = _native.encode_counts(mask)
    if native_counts is not None:
        return native_counts
    flat = np.asarray(mask, dtype=bool).reshape(-1, order="F")
    if flat.size == 0:
        return np.zeros(1, dtype=np.int64)
    boundaries = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate(([0], boundaries, [flat.size])))
    if flat[0]:  # counts must start with a zero-run
        runs = np.concatenate(([0], runs))
    return runs.astype(np.int64)


def counts_to_mask(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    assert total == h * w, f"rle covers {total}, expected {h * w}"
    native_mask = _native.decode_counts(counts, h, w)
    if native_mask is not None:
        return native_mask
    flat = np.zeros(h * w, dtype=bool)
    ends = np.cumsum(counts)
    starts = ends - counts
    for i in range(1, len(counts), 2):
        flat[starts[i] : ends[i]] = True
    return flat.reshape(h, w, order="F")


def counts_to_string(counts: Sequence[int]) -> str:
    """COCO compressed counts encoding (difference + signed base-32 varint).

    Hot path of results.json writing (one call per prediction-frame); the
    native encoder does it in C, this Python loop is the fallback."""
    native = _native.counts_to_string(np.asarray(counts, np.int64))
    if native is not None:
        return native
    out = []
    counts = list(counts)
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5  # arithmetic shift (python ints)
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def string_to_counts(s: Union[str, bytes]) -> List[int]:
    native = _native.string_to_counts(s)
    if native is not None:
        return native.tolist()
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        while True:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            i += 1
            k += 1
            if not (c & 0x20):
                if c & 0x10:
                    x |= -1 << (5 * k)
                break
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode(mask: np.ndarray) -> RLE:
    """(H, W) binary mask -> {"size": [H, W], "counts": str} (compressed)."""
    h, w = mask.shape
    return {"size": [h, w], "counts": counts_to_string(mask_to_counts(mask))}


def encode_window(
    crop: np.ndarray, y0: int, x0: int, h: int, w: int
) -> RLE:
    """RLE of a zero (h, w) canvas with the (ch, cw) bool `crop` pasted
    at (y0, x0) — identical output to pasting + `encode`, without
    materializing the canvas. The eval transport ships NMS survivors as
    bbox crops (evaluation/inference.py), making this the results.json
    hot path: O(crop) work instead of O(canvas) + a Fortran-order copy."""
    counts = _native.encode_window_counts(crop, y0, x0, h, w)
    if counts is None:  # no native lib: paste + standard encoder
        canvas = np.zeros((h, w), bool)
        ch, cw = crop.shape
        canvas[y0: y0 + ch, x0: x0 + cw] = crop
        counts = mask_to_counts(canvas)
    return {"size": [h, w], "counts": counts_to_string(counts)}


def decode(rle: RLE) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return counts_to_mask(counts, h, w)


def area(rle: RLE) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return int(sum(counts[1::2]))


def to_bbox(rle: RLE) -> List[float]:
    """RLE -> [x, y, w, h] bbox (xywh, as pycocotools toBbox)."""
    mask = decode(rle)
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return [0.0, 0.0, 0.0, 0.0]
    x0, x1 = xs.min(), xs.max()
    y0, y1 = ys.min(), ys.max()
    return [float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)]


def polygons_to_mask(polygons: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """COCO polygon segmentation -> binary mask, equal to JAX's (and so to
    `cv2.fillPoly`) pixel for pixel: each part's coordinates rounded half to
    even and cast to int32, parts of fewer than 6 numbers dropped, all parts
    filled in one pass by the port's native scanline fill
    (`native.fill_polygons`), cv2 or not."""
    pts = [
        np.round(np.asarray(p, dtype=np.float64).reshape(-1, 2)).astype(np.int32)
        for p in polygons
        if len(p) >= 6
    ]
    return _native.fill_polygons(pts, h, w).astype(bool)


def iou_intersection_union(a: RLE, b: RLE):
    """Run-length-free intersection/union via decoded masks (fine for the
    per-frame sizes YTVIS eval touches; optimize to run-merge if hot)."""
    ma, mb = decode(a), decode(b)
    inter = np.logical_and(ma, mb).sum()
    union = np.logical_or(ma, mb).sum()
    return int(inter), int(union)
