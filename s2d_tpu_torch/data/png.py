"""A PNG codec of the port's own, on zlib and numpy: the card's machine has
neither cv2 nor PIL, and keymask discovery reads its frames and its mask
PNGs and writes its candidate masks as PNG.

`read_png` reads 8-bit non-interlaced files of every colour type (0 grey,
2 RGB, 3 palette, 4 grey + alpha, 6 RGBA) and all five scanline filters,
and returns (H, W, 3) uint8 RGB as `cv2.cvtColor(cv2.imread(path),
cv2.COLOR_BGR2RGB)` does: grey replicated to 3 channels, a palette
expanded, alpha dropped (not composited). Another bit depth, an interlaced
file or a damaged chunk raises ValueError naming the file. The filters
are undone by the port's native library (`native.png_unfilter`) where it
builds, else by `unfilter` below.

`write_png` writes (H, W) grey or (H, W, 3) RGB uint8, every row unfiltered
(filter type 0), zlib level 1 (cv2's default PNG compression).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import native as _native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunks(blob: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(blob):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        data = blob[pos + 8:end]
        (crc,) = struct.unpack(">I", blob[end:end + 4])
        if zlib.crc32(kind + data) != crc:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, data
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError(f"{path}: no IEND chunk")


def unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """h scanlines (a filter-type byte, then `stride` bytes) -> the (h,
    stride) reconstructed bytes: numpy for filters 0-2, a per-byte loop for
    3 (Average) and 4 (Paeth)."""
    rows = np.asarray(data, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, raw = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            out[y] = raw
        elif ftype == 1:  # Sub: a running sum, mod 256, per channel
            out[y] = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            out[y] = raw + prior
        elif ftype in (3, 4):
            cur = bytearray(stride)
            up = prior.tolist()
            for i, x in enumerate(raw.tolist()):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (x + pred) & 0xFF
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the PNG file at `path` (see the module doc)."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, data in _chunks(blob, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in CHANNELS or interlace:
        raise ValueError(f"{path}: bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}; only 8-bit non-interlaced PNGs are read")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    ch = CHANNELS[ctype]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data, expected {h * (stride + 1)}")
    raw = raw[:h * (stride + 1)]
    try:
        px = _native.png_unfilter(raw, h, stride, ch)
        if px is None:
            px = unfilter(raw, h, stride, ch)
    except ValueError as err:
        raise ValueError(f"{path}: {err}") from None
    px = px.reshape(h, w, ch)
    if ctype == 3:
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index past the {len(palette)} PLTE entries")
        return palette[px[..., 0]]
    if ch <= 2:  # grey, grey + alpha
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str, image: np.ndarray) -> None:
    """Writes (H, W) grey or (H, W, 3) RGB uint8 `image` to `path`."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, not {image.dtype} "
                         f"{image.shape}")
    h, w = image.shape[:2]
    ctype = 0 if image.ndim == 2 else 2
    rows = np.zeros((h, 1 + image[0].size), np.uint8)  # filter type 0 on every row
    rows[:, 1:] = image.reshape(h, -1)
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + _chunk(b"IEND", b""))
