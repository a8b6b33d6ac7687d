"""ctypes bindings for the port's native RLE ops (`rle_ops.cpp`) and the
PNG codec's scanline unfilter.

The port builds its own copy of the C++ source, never the JAX package's
binary: at the first `lib()` call, `g++ -O3 -shared -fPIC` compiles
`rle_ops.cpp` into `build/s2d_tpu_torch/librle_ops_<hash>.so` at the root
of the checkout, named by a hash of the source and flags (as `_build.py`
names the CUDA library). Without g++, or when the build fails, `lib()`
returns None and every wrapper returns None, so the callers in
`data/rle.py`, `data/png.py` and `evaluation/ytvos_eval.py` take their
numpy paths.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

SOURCE = Path(__file__).resolve().parent / "rle_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "s2d_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I = ctypes.c_int64

SIGNATURES = {
    "rle_encode": (_I, [_u8p, _I, _i64p, _I]),
    "rle_decode": (None, [_i64p, _I, _u8p, _I]),
    "track_iou_matrix": (None, [_i64p, _i64p, _i64p, _i64p, _I, _I, _I, _f64p]),
    "rle_encode_window": (_I, [_u8p, _I, _I, _I, _I, _I, _I, _i64p, _I]),
    "rle_counts_to_string": (_I, [_i64p, _I, ctypes.c_char_p, _I]),
    "rle_string_to_counts": (_I, [ctypes.c_char_p, _I, _i64p, _I]),
    "png_unfilter": (_I, [_u8p, _I, _I, _I, _u8p]),
}


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librle_ops_{digest.hexdigest()[:16]}.so"


def _compile(target: Path) -> bool:
    """g++ into a temporary file beside the target, then rename: a
    concurrent or cut build never leaves a half-written library under the
    final name."""
    try:
        target.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    except OSError:
        return False
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if this source has no build yet;
    None where it cannot be built or loaded."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = library_path()
    if not path.exists() and not _compile(path):
        return None
    try:
        cdll = ctypes.CDLL(str(path))
    except OSError:
        return None
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _LIB = cdll
    return _LIB


def encode_counts(mask: np.ndarray) -> Optional[np.ndarray]:
    """(H, W) mask -> run counts via the native encoder (None if no lib)."""
    cdll = lib()
    if cdll is None:
        return None
    flat = np.ascontiguousarray(
        np.asarray(mask, np.uint8).reshape(-1, order="F")
    )
    cap = flat.size + 2
    out = np.empty(cap, np.int64)
    k = cdll.rle_encode(flat, flat.size, out, cap)
    if k < 0:
        return None
    return out[:k].copy()


def encode_window_counts(
    crop: np.ndarray, y0: int, x0: int, h: int, w: int
) -> Optional[np.ndarray]:
    """Run counts of a zero (h, w) canvas with the row-major (ch, cw)
    `crop` pasted at (y0, x0), without materializing the canvas. None if
    no lib or the crop falls outside the canvas."""
    cdll = lib()
    if cdll is None:
        return None
    crop = np.ascontiguousarray(np.asarray(crop, np.uint8))
    ch, cw = crop.shape
    cap = ch * cw + 2 * cw + 4
    out = np.empty(cap, np.int64)
    k = cdll.rle_encode_window(
        crop, ch, cw, int(y0), int(x0), int(h), int(w), out, cap
    )
    if k < 0:
        return None
    return out[:k].copy()


def decode_counts(counts: np.ndarray, h: int, w: int) -> Optional[np.ndarray]:
    cdll = lib()
    if cdll is None:
        return None
    counts = np.ascontiguousarray(np.asarray(counts, np.int64))
    flat = np.empty(h * w, np.uint8)
    cdll.rle_decode(counts, counts.size, flat, flat.size)
    return flat.reshape(h, w, order="F").astype(bool)


def counts_to_string(counts: np.ndarray) -> Optional[str]:
    """Run counts -> COCO compressed-counts string (None if no lib)."""
    cdll = lib()
    if cdll is None:
        return None
    counts = np.ascontiguousarray(np.asarray(counts, np.int64))
    # worst case: 13 chars per count (int64 varint, 5 bits/char)
    cap = 13 * max(counts.size, 1) + 1
    buf = ctypes.create_string_buffer(cap)
    n = cdll.rle_counts_to_string(counts, counts.size, buf, cap)
    if n < 0:
        return None
    return buf.raw[:n].decode("ascii")


def string_to_counts(s: Union[str, bytes]) -> Optional[np.ndarray]:
    """COCO compressed-counts string -> run counts (None if no lib or
    malformed/truncated input: callers fall back to the Python parser)."""
    cdll = lib()
    if cdll is None:
        return None
    raw = s.encode("ascii") if isinstance(s, str) else bytes(s)
    cap = len(raw) + 1  # every count takes >= 1 char
    out = np.empty(cap, np.int64)
    m = cdll.rle_string_to_counts(raw, len(raw), out, cap)
    if m < 0:
        return None
    return out[:m].copy()


def _pack_tracks(tracks: Sequence[Sequence[Optional[np.ndarray]]]):
    """tracks: per track, per frame run-count arrays (or None)."""
    counts: List[np.ndarray] = []
    offsets = [0]
    for track in tracks:
        for frame in track:
            if frame is not None and len(frame):
                counts.append(np.asarray(frame, np.int64))
                offsets.append(offsets[-1] + len(frame))
            else:
                offsets.append(offsets[-1])
    all_counts = (
        np.concatenate(counts) if counts else np.zeros(0, np.int64)
    )
    return np.ascontiguousarray(all_counts), np.asarray(offsets, np.int64)


def track_iou_matrix(
    d_tracks: Sequence[Sequence[Optional[np.ndarray]]],
    g_tracks: Sequence[Sequence[Optional[np.ndarray]]],
    t: int,
) -> Optional[np.ndarray]:
    """Pairwise spatio-temporal IoU of detection vs gt run-count tracks."""
    cdll = lib()
    if cdll is None:
        return None
    d_counts, d_offsets = _pack_tracks(d_tracks)
    g_counts, g_offsets = _pack_tracks(g_tracks)
    d_n, g_n = len(d_tracks), len(g_tracks)
    out = np.zeros(d_n * g_n, np.float64)
    if d_n and g_n:
        cdll.track_iou_matrix(
            d_counts, d_offsets, g_counts, g_offsets, d_n, g_n, t, out
        )
    return out.reshape(d_n, g_n)


def png_unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> Optional[np.ndarray]:
    """PNG scanlines (h rows of a filter byte + `stride` bytes) -> the (h,
    stride) reconstructed bytes (None if no lib). Raises ValueError on an
    unknown filter type."""
    cdll = lib()
    if cdll is None:
        return None
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    if data.size != h * (stride + 1) or bpp < 1:
        raise ValueError(f"{data.size} bytes of scanlines for {h} rows of {stride} bytes, "
                         f"{bpp} a pixel")
    out = np.empty((h, stride), np.uint8)
    bad = cdll.png_unfilter(data, h, stride, bpp, out)
    if bad >= 0:
        raise ValueError(f"PNG row {bad}: unknown filter type {data[bad * (stride + 1)]}")
    return out
