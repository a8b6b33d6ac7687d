"""The port's JPEG codec (`s2d_tpu_torch/data/jpeg.py` on
`native/jpeg.cpp`) against cv2 on the CPU, and the readers built on it.

Tolerance: exact everywhere. `read_jpeg` must equal `cv2.imread(path,
cv2.IMREAD_COLOR)[..., ::-1]` byte for byte (what the JAX mapper reads), on
files written here by cv2 (every sampling factor it writes, 4:1:1 among
them, progressive, restart intervals, odd sizes) and by PIL (grey,
progressive, its subsamplings, CMYK, every EXIF orientation, Adobe RGB), on
the committed fixtures of `tests/data/jpeg/` (arithmetic coding, YCCK,
sampling ratios up to 4, lossless files; their digests `chip_smoke.py` phase
16 also checks on the card's machine), and on damaged files that cv2 still
reads (truncated at every length, cut mid-scan, corrupt entropy data,
progressive files whose blocks libjpeg smooths). Where cv2 returns no image
the port raises: ValueError naming the file for the kinds it refuses
(12-bit, hierarchical, DNL, grey or arithmetic lossless, fractional
sampling), OSError for a damaged file.
`write_jpeg`'s files decode to the same pixels in cv2 and in `read_jpeg`,
and at quality 95 stay within 38 dB PSNR of a smooth input.
"""
import hashlib
import io
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import cv2
from PIL import Image

from s2d_tpu_torch import native
from s2d_tpu_torch.data import jpeg, mapper
from s2d_tpu_torch.data.png import write_png

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "jpeg"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
PSNR_MIN = 38.0


def scene(h, w, seed=0):
    """A smooth gradient with flat discs and a little noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w].astype(np.float32)
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                    (x + y) * 128 / max(h + w - 2, 1)], -1)
    for _ in range(3):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, 10)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.randint(0, 256, 3)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def cv2_bytes(rgb, quality=85, sampling=None, progressive=0, restart=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    img = rgb if rgb.ndim == 2 else np.ascontiguousarray(rgb[..., ::-1])
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def pil_bytes(img, mode_cmyk=False, **kwargs):
    bio = io.BytesIO()
    im = Image.fromarray(img)
    (im.convert("CMYK") if mode_cmyk else im).save(bio, "JPEG", **kwargs)
    return bio.getvalue()


def exif(orientation):
    e = Image.Exif()
    e[0x0112] = orientation
    return e.tobytes()


SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
# name -> bytes of a file cv2 decodes; sizes odd in both directions, and
# 1 and 2 samples wide (where libjpeg replicates instead of the triangle
# filter)
CASES = {
    **{f"cv2_{s}_{h}x{w}{'_prog' if p else ''}{'_rst' if r else ''}":
       (lambda s=s, h=h, w=w, p=p, r=r: cv2_bytes(scene(h, w, h + w), 80, SAMPLING[s], p, r))
       for s in SAMPLING for (h, w) in ((17, 31), (33, 47)) for p in (0, 1) for r in (0, 2)},
    **{f"cv2_420_{h}x{w}": (lambda h=h, w=w: cv2_bytes(scene(h, w), 90, SAMPLING["420"]))
       for (h, w) in ((1, 1), (2, 3), (3, 2), (9, 4), (5, 17))},
    "cv2_noise_q100_444": lambda: cv2_bytes(
        np.random.RandomState(3).randint(0, 256, (24, 40, 3), np.uint8), 100, SAMPLING["444"]),
    "cv2_noise_q10_420_prog": lambda: cv2_bytes(
        np.random.RandomState(4).randint(0, 256, (24, 40, 3), np.uint8), 10, SAMPLING["420"], 1),
    "cv2_grey": lambda: cv2_bytes(scene(33, 47)[..., 0]),
    **{f"pil_sub{sub}{'_prog' if p else ''}": (
        lambda sub=sub, p=p: pil_bytes(scene(33, 47, sub), quality=85, subsampling=sub,
                                       progressive=p))
       for sub in (0, 1, 2) for p in (False, True)},
    "pil_grey_prog": lambda: pil_bytes(scene(17, 31)[..., 0], progressive=True),
    "pil_optimized": lambda: pil_bytes(scene(33, 47), optimize=True),
    "pil_adobe_rgb": lambda: pil_bytes(scene(17, 31), keep_rgb=True),
    **{f"pil_cmyk{'_prog' if p else ''}_{h}x{w}": (
        lambda h=h, w=w, p=p: pil_bytes(scene(h, w, 5), mode_cmyk=True, quality=85,
                                        progressive=p))
       for (h, w) in ((16, 16), (13, 37)) for p in (False, True)},
    **{f"cv2_411_{h}x{w}{'_prog' if p else ''}{'_rst' if r else ''}":
       (lambda h=h, w=w, p=p, r=r: cv2_bytes(scene(h, w, h), 80, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
                                             p, r))
       for (h, w) in ((9, 5), (17, 31), (33, 47)) for p in (0, 1) for r in (0, 2)},
    **{f"pil_exif{o}": (lambda o=o: pil_bytes(scene(17, 31, o), exif=exif(o)))
       for o in range(1, 9)},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_read_jpeg_equals_cv2(tmp_path, name):
    path = tmp_path / f"{name}.jpg"
    path.write_bytes(CASES[name]())
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
    got = jpeg.read_jpeg(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _patched(blob, offset_of, value):
    """`blob` with the byte at `offset_of(blob)` set to `value`."""
    out = bytearray(blob)
    out[offset_of(blob)] = value
    return bytes(out)


SOF0 = lambda b: b.index(b"\xff\xc0") + 1  # noqa: E731  the SOF marker's code
PRECISION = lambda b: b.index(b"\xff\xc0") + 4  # noqa: E731
HEIGHT = lambda b: b.index(b"\xff\xc0") + 6  # noqa: E731  its low byte
FIRST_SAMPLING = lambda b: b.index(b"\xff\xc0") + 11  # noqa: E731
# kinds cv2 returns no image for, each refused by name
REFUSED = {
    # factors 3x1 and 2x1: no integral ratio (libjpeg: "fractional sampling")
    "cmyk": (lambda: _patched(_patched(pil_bytes(scene(16, 16), quality=80, mode_cmyk=True),
                                       FIRST_SAMPLING, 0x31),
                              lambda b: FIRST_SAMPLING(b) + 3, 0x21), "fractional"),
    "arithmetic": (lambda: _patched(cv2_bytes(scene(16, 16)), SOF0, 0xCB),
                   "arithmetic-coded lossless"),
    "lossless": (lambda: _patched(cv2_bytes(scene(16, 16)[..., 0]), SOF0, 0xC3), "grey lossless"),
    "12-bit": (lambda: _patched(cv2_bytes(scene(16, 16)), PRECISION, 12), "12-bit"),
    "hierarchical": (lambda: _patched(cv2_bytes(scene(16, 16)), SOF0, 0xC5), "hierarchical"),
    "dnl": (lambda: _patched(_patched(cv2_bytes(scene(16, 16)), HEIGHT, 0),
                             lambda b: HEIGHT(b) - 1, 0), "DNL"),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_kinds_raise_naming_the_file(tmp_path, kind):
    make, words = REFUSED[kind]
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(make())
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match=words) as info:
        jpeg.read_jpeg(str(path))
    assert str(path) in str(info.value)


def _corrupt(blob, seed):
    """`blob` with 3 bytes of its entropy-coded data replaced."""
    rng = np.random.RandomState(seed)
    out = bytearray(blob)
    start = blob.index(b"\xff\xda") + 14
    for i in rng.randint(start, len(blob) - 2, 3):
        out[i] = rng.randint(0, 256)
    return bytes(out)


BASE = lambda **kw: cv2_bytes(scene(40, 56), 85, **kw)  # noqa: E731
# damaged files cv2.imread still returns an image for (with a warning):
# read as libjpeg reads them (a block that runs out of data takes zero bits,
# the rest of its scan stays as it was, grey in a first scan; a code no table
# holds is symbol 0; a progressive file cut before its last scans has its
# blocks smoothed)
DAMAGED = {
    "no_eoi": (lambda: BASE()[:-2], None),
    "cut_mid_scan": (lambda: BASE()[:1200], None),
    "cut_mid_scan_restarts": (lambda: BASE(restart=1)[:1300], None),
    "progressive_missing_scans": (lambda: BASE(progressive=1)[:900], None),
}


@pytest.mark.parametrize("kind", sorted(DAMAGED))
def test_damaged_files_read_as_cv2_or_raise(tmp_path, kind):
    make, refused = DAMAGED[kind]
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(make())
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert want is not None
    if refused:
        with pytest.raises(OSError, match=refused) as info:
            jpeg.read_jpeg(str(path))
        assert str(path) in str(info.value)
    else:
        np.testing.assert_array_equal(jpeg.read_jpeg(str(path)), want[..., ::-1])


def _parts_from_cv2(path, blobs):
    """How many of `blobs`, written to `path` in turn, read_jpeg decodes to
    cv2's image; asserts that it raises wherever cv2 returns none, and
    decodes the same pixels wherever cv2 returns an image."""
    same = 0
    for i, blob in enumerate(blobs):
        with open(path, "wb") as f:
            f.write(blob)
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        if want is None:
            with pytest.raises((OSError, ValueError)):
                jpeg.read_jpeg(path)
            continue
        np.testing.assert_array_equal(jpeg.read_jpeg(path), want[..., ::-1], err_msg=f"file {i}")
        same += 1
    return same


@pytest.mark.parametrize("progressive", [0, 1])
def test_corrupt_entropy_data_reads_as_cv2(tmp_path, progressive):
    """750 files with 3 bytes after the first scan header replaced (stray
    markers, bad codes, lost restart markers, broken later scan headers and
    tables, progressive files whose blocks libjpeg smooths): wherever cv2
    returns an image, read_jpeg returns the same, and wherever cv2 returns
    none, read_jpeg raises."""
    bases = [BASE(progressive=progressive, restart=r) for r in range(3)]
    same = _parts_from_cv2(str(tmp_path / "corrupt.jpg"),
                           (_corrupt(bases[seed % 3], seed) for seed in range(750)))
    assert same >= 250  # not vacuous: about half of the files cv2 reads


@pytest.mark.parametrize("progressive", [0, 1])
def test_cut_files_read_as_cv2(tmp_path, progressive):
    """Files cut at 97 lengths: in a scan (a progressive file then lacks its
    last scans, and libjpeg smooths its blocks), in a later scan's header, in
    a Huffman table past the first scan (libjpeg reads on through the EOI
    markers its source manager inserts), before the first scan (no image)."""
    blobs = []
    for r in range(3):
        blob = BASE(progressive=progressive, restart=r)
        blobs += [blob[:len(blob) * k // 98] for k in range(1 + r, 98, 3)]
    assert _parts_from_cv2(str(tmp_path / "cut.jpg"), blobs) >= 40


def test_a_file_cut_in_its_headers_raises(tmp_path):
    path = tmp_path / "cut.jpg"
    path.write_bytes(BASE()[:300])
    with pytest.raises(OSError, match="damaged JPEG"):
        jpeg.read_jpeg(str(path))
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixtures_match_cv2_digests(name):
    """The committed fixtures against the digests cv2 gave for them (the
    check `chip_smoke.py` phase 16 makes on the card's machine), and against
    cv2 itself here."""
    path = str(FIXTURES / name)
    want = DIGESTS[name]
    if "refused" in want:
        assert cv2.imread(path, cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match=name):
            jpeg.read_jpeg(path)
        return
    got = jpeg.read_jpeg(path)
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])


@pytest.mark.parametrize("subsampling", ["420", "422", "444", "grey"])
def test_write_jpeg_decodes_alike_and_close(tmp_path, subsampling):
    y, x = np.mgrid[:96, :136].astype(np.float32)
    smooth = np.stack([128 + 100 * np.sin(x / 17), 128 + 90 * np.cos(y / 13),
                       (x + y) * 255 / 230], -1).astype(np.uint8)
    img = smooth[..., 1] if subsampling == "grey" else smooth
    path = str(tmp_path / "out.jpg")
    jpeg.write_jpeg(path, img, quality=95, subsampling="444" if subsampling == "grey" else subsampling)
    got = jpeg.read_jpeg(path)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    ref = np.repeat(img[..., None], 3, 2) if img.ndim == 2 else img
    mse = np.mean((got.astype(np.float64) - ref) ** 2)
    assert 10 * np.log10(255.0 ** 2 / mse) >= PSNR_MIN


def test_load_image_robust_reads_by_content_without_cv2_or_pil(tmp_path, monkeypatch):
    """JPEG and PNG are told apart by their first bytes, not the file name,
    and read by the port's codecs with cv2 and PIL unimportable; another
    format then raises ImportError naming both."""
    img = scene(21, 30)
    jpg_named_png, png_named_jpg = tmp_path / "a.png", tmp_path / "b.jpg"
    jpg_named_png.write_bytes(cv2_bytes(img))
    write_png(str(png_named_jpg), img)
    want = cv2.imread(str(jpg_named_png), cv2.IMREAD_COLOR)[..., ::-1]
    (tmp_path / "c.bmp").write_bytes(cv2.imencode(".bmp", img)[1].tobytes())
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(mapper.load_image_robust(str(jpg_named_png)), want)
    np.testing.assert_array_equal(mapper.load_image_robust(str(png_named_jpg)), img)
    with pytest.raises(ImportError, match="cv2.*PIL"):
        mapper.load_image_robust(str(tmp_path / "c.bmp"))


def test_decodes_on_threads_beside_each_other(tmp_path):
    """Decoding on several threads at once (the loader's and the eval's
    prefetch threads) gives each thread cv2's pixels."""
    paths = []
    for i in range(4):
        p = tmp_path / f"{i}.jpg"
        p.write_bytes(cv2_bytes(scene(64, 96, i), 90, progressive=i % 2))
        paths.append(str(p))
    want = [cv2.imread(p, cv2.IMREAD_COLOR)[..., ::-1] for p in paths]
    errors = []

    def work(k):
        try:
            for _ in range(5):
                np.testing.assert_array_equal(jpeg.read_jpeg(paths[k]), want[k])
        except Exception as err:  # noqa: BLE001  reported below
            errors.append(err)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


def test_two_processes_build_the_libraries_at_once(tmp_path):
    """Two processes that find no build of the native sources build them at
    the same time into one directory: both load a whole library (each build
    goes to a temporary file that is renamed into place)."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from s2d_tpu_torch import native\n"
        f"native.BUILD_DIR = __import__('pathlib').Path({str(tmp_path)!r})\n"
        "assert native.jpeg_lib() is not None and native.lib() is not None\n"
        "m = native.fill_polygons([np.array([[0, 0], [5, 0], [5, 5]])], 6, 6)\n"
        "assert m.sum() == 21, m\n"
        f"assert (__import__('s2d_tpu_torch.data.jpeg', fromlist=['x']).read_jpeg({str(FIXTURES / 'cv2_444_17x31.jpg')!r}).shape == (17, 31, 3))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    for proc in procs:
        assert proc.wait(timeout=240) == 0, proc.stderr.read()[-2000:]
    built = sorted(p.name for p in tmp_path.iterdir())
    assert built == sorted([native.library_path(native.JPEG_SOURCE).name,
                            native.library_path(native.SOURCE).name]), built
