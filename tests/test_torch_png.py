"""The port's PNG codec (`s2d_tpu_torch/data/png.py`) against cv2 and PIL:
every colour type (0 grey, 2 RGB, 3 palette with and without tRNS, 4
grey + alpha, 6 RGBA) with all five scanline filters in one file, through
both routes of the unfilter (the native library and the numpy twin); files
written by cv2 and PIL (their own filter choices); what raises; and the
writer read back by cv2 and PIL."""
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from s2d_tpu_torch import native
from s2d_tpu_torch.data import png

H, W = 13, 17


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(px: np.ndarray, bpp: int) -> bytes:
    """(H, stride) uint8 -> scanlines, row y filtered with type y % 5."""
    out = []
    prior = np.zeros(px.shape[1], np.int64)
    for y, row in enumerate(px.astype(np.int64)):
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        pred = [0 * row, left, prior, (left + prior) // 2, _paeth(left, prior, upleft)][y % 5]
        out.append(bytes([y % 5]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prior = row
    return b"".join(out)


def _png(px: np.ndarray, ctype: int, extra=b"", interlace=0, depth=8) -> bytes:
    bpp = png.CHANNELS[ctype]
    ihdr = struct.pack(">IIBBBBB", px.shape[1], px.shape[0], depth, ctype, 0, 0, interlace)
    data = _filter_rows(px.reshape(px.shape[0], -1), bpp)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr) + extra
            + png._chunk(b"IDAT", zlib.compress(data)) + png._chunk(b"IEND", b""))


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _read_both_routes(path, monkeypatch):
    native_px = png.read_png(str(path))
    with monkeypatch.context() as m:
        m.setattr(native, "png_unfilter", lambda *a: None)
        numpy_px = png.read_png(str(path))
    np.testing.assert_array_equal(native_px, numpy_px)
    return native_px


@pytest.fixture(scope="module")
def native_built():
    assert native.lib() is not None, "the native library must build here (g++)"


@pytest.mark.parametrize("ctype, trns", [(0, False), (2, False), (3, False), (3, True),
                                         (4, False), (6, False)])
def test_every_colour_type_and_filter(tmp_path, monkeypatch, native_built, ctype, trns):
    rng = np.random.RandomState(ctype)
    extra = b""
    if ctype == 3:
        palette = rng.randint(0, 256, (40, 3), np.uint8)
        px = rng.randint(0, 40, (H, W, 1), np.uint8)
        extra = png._chunk(b"PLTE", palette.tobytes())
        if trns:
            extra += png._chunk(b"tRNS", bytes(range(0, 200, 10)))
    else:
        px = rng.randint(0, 256, (H, W, png.CHANNELS[ctype]), np.uint8)
        px[:, :5] = px[:1, :5]  # runs, so Sub/Up/Average/Paeth predict exactly too
    path = tmp_path / f"t{ctype}.png"
    path.write_bytes(_png(px, ctype, extra))
    got = _read_both_routes(path, monkeypatch)
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _cv2_rgb(path))
    np.testing.assert_array_equal(got, _pil_rgb(path))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_files_written_by_cv2_and_pil(tmp_path, monkeypatch, native_built, mode):
    rng = np.random.RandomState(1)
    rgb = rng.randint(0, 256, (48, 61, 3), np.uint8)
    rgb[10:30, 5:50] = (200, 10, 90)  # flat areas make the encoders pick several filters
    img = Image.fromarray(rgb).convert(mode) if mode != "P" else Image.fromarray(rgb).quantize(64)
    pil_path = tmp_path / f"pil_{mode}.png"
    img.save(pil_path)
    np.testing.assert_array_equal(_read_both_routes(pil_path, monkeypatch), _cv2_rgb(pil_path))
    if mode in ("L", "RGB", "RGBA"):
        arr = np.asarray(img)
        cv_path = tmp_path / f"cv_{mode}.png"
        cv2.imwrite(str(cv_path), arr if arr.ndim == 2 else cv2.cvtColor(
            arr, cv2.COLOR_RGB2BGR if mode == "RGB" else cv2.COLOR_RGBA2BGRA))
        np.testing.assert_array_equal(_read_both_routes(cv_path, monkeypatch), _cv2_rgb(cv_path))


def test_unsupported_and_damaged_files_raise_with_the_name(tmp_path):
    px = np.zeros((4, 5, 3), np.uint8)
    cases = {
        "interlaced.png": _png(px, 2, interlace=1),
        "sixteen.png": None,
        "badfilter.png": None,
        "badcrc.png": _png(px, 2)[:-5] + b"\x00" + _png(px, 2)[-4:],
        "notpng.png": b"GIF89a....",
    }
    cv2.imwrite(str(tmp_path / "sixteen.png"), np.full((4, 5, 3), 1000, np.uint16))
    good = bytearray(_png(px, 2))
    blob = zlib.decompress(bytes(good[good.index(b"IDAT") + 4:good.index(b"IEND") - 8]))
    bad = b"\x07" + blob[1:]  # row 0 with filter type 7
    cases["badfilter.png"] = (png.SIGNATURE + png._chunk(
        b"IHDR", struct.pack(">IIBBBBB", 5, 4, 8, 2, 0, 0, 0)) + png._chunk(
        b"IDAT", zlib.compress(bad)) + png._chunk(b"IEND", b""))
    for name, blob in cases.items():
        if blob is not None:
            (tmp_path / name).write_bytes(blob)
        with pytest.raises(ValueError, match=name):
            png.read_png(str(tmp_path / name))


def test_writer_round_trip(tmp_path):
    rng = np.random.RandomState(2)
    rgb = rng.randint(0, 256, (31, 45, 3), np.uint8)
    grey = (rng.rand(31, 45) > 0.5).astype(np.uint8) * 255
    png.write_png(str(tmp_path / "rgb.png"), rgb)
    png.write_png(str(tmp_path / "grey.png"), grey)
    np.testing.assert_array_equal(_cv2_rgb(tmp_path / "rgb.png"), rgb)
    np.testing.assert_array_equal(_pil_rgb(tmp_path / "rgb.png"), rgb)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "grey.png"), cv2.IMREAD_UNCHANGED),
                                  grey)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "grey.png")),
                                  np.repeat(grey[..., None], 3, axis=2))
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(tmp_path / "f.png"), rgb.astype(np.float32))
