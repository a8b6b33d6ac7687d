"""The port's JPEG codec, on `native/jpeg.cpp`: the card's machine has
neither cv2 nor PIL.

`read_jpeg(path)` returns (H, W, 3) uint8 RGB equal to
`cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]` (what the JAX mapper reads),
the EXIF orientation applied as cv2 applies it. It reads baseline,
extended sequential and progressive files, Huffman or arithmetic coded, and
lossless files, of 8-bit samples with 1, 3 or 4 (CMYK, YCCK) components and
any integral sampling ratio, and damaged files as libjpeg reads them where
cv2 still returns an image (a progressive file cut before its last scans
has its blocks smoothed as libjpeg smooths them). Where cv2 returns no image
it raises: ValueError, naming the file and the reason, for the kinds it
refuses (12- and 16-bit samples, hierarchical files, a DNL height, grey or
arithmetic lossless files, fractional sampling ratios); OSError for a
damaged file.

`write_jpeg(path, rgb, quality=95, subsampling="420")` writes a baseline
file (libjpeg's quality scaling of the Annex K tables, the standard Huffman
tables), 4:2:0, 4:2:2 or 4:4:4, or grey for an (H, W) array.

Both go through ctypes, which releases the GIL, so the loader's and the
eval's prefetch threads decode beside the main thread. Without the native
library (no g++) both raise; there is no other decoder.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import native as _native

SOI = b"\xff\xd8\xff"
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}
_REASON = 256


def _lib():
    cdll = _native.jpeg_lib()
    if cdll is None:
        raise RuntimeError(f"the JPEG codec ({_native.JPEG_SOURCE.name}) could not be built "
                           "with g++; the port has no other JPEG codec")
    return cdll


def _fail(path: str, status: int, reason: bytes):
    why = reason.split(b"\0", 1)[0].decode("ascii", "replace")
    if status == 1:
        raise ValueError(f"{path}: unsupported JPEG: {why}")
    raise OSError(f"{path}: damaged JPEG: {why}")


def _header(cdll, blob: bytes, path: str) -> np.ndarray:
    info = np.zeros(4, np.int32)
    reason = ctypes.create_string_buffer(_REASON)
    status = cdll.s2d_jpeg_header(blob, len(blob), info, reason, _REASON)
    if status:
        _fail(path, status, reason.raw)
    return info


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """An image as stored -> as shown, for an EXIF orientation 1-8 (others
    leave it), as OpenCV's ApplyExifOrientation."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flips:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def read_jpeg(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the JPEG file at `path` (see the module doc)."""
    with open(path, "rb") as f:
        blob = f.read()
    cdll = _lib()
    h, w, _, orientation = _header(cdll, blob, path).tolist()
    out = np.empty((h, w, 3), np.uint8)
    reason = ctypes.create_string_buffer(_REASON)
    status = cdll.s2d_jpeg_decode(blob, len(blob), out, h, w, reason, _REASON)
    if status:
        _fail(path, status, reason.raw)
    return _orient(out, orientation)


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95, subsampling: str = "420") -> None:
    """Writes (H, W) grey or (H, W, 3) RGB uint8 `rgb` to `path` as a
    baseline JPEG."""
    image = np.ascontiguousarray(rgb)
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"write_jpeg takes (H, W) or (H, W, 3) uint8, not {image.dtype} "
                         f"{image.shape}")
    if subsampling not in SUBSAMPLING:
        raise ValueError(f"subsampling {subsampling!r}; one of {sorted(SUBSAMPLING)}")
    h, w = image.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a JPEG holds 1..65535 rows and columns, not {h}x{w}")
    flat = image.reshape(-1)
    cdll = _lib()
    cap = 2 * flat.size + 4096
    while True:  # the encoder says how much room it needs when cap is short
        out = np.empty(cap, np.uint8)
        n = cdll.s2d_jpeg_encode(flat, h, w, 1 if image.ndim == 2 else 3, int(quality),
                                 SUBSAMPLING[subsampling], out, cap)
        if n > 0:
            break
        if n == 0:
            raise MemoryError(f"encoding a {h}x{w} JPEG")
        cap = -n
    with open(path, "wb") as f:
        f.write(out[:n].tobytes())
