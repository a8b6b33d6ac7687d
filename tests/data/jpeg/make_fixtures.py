"""Writes the JPEG fixtures of tests/test_torch_jpeg.py and chip_smoke.py
phase 16, and `digests.json`: per file, the SHA-256 of
`cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]` (C order) and its shape, or,
where cv2 returns no image, the exception the port's reader raises instead.

Files come from cv2 and PIL, and from the libjpeg-turbo that Pillow bundles
(`pillow.libs/libjpeg-*.so.62*`), driven through ctypes for what neither
writes: arithmetic coding, YCCK, any sampling factors, lossless and 12-bit
files. A few kinds no encoder writes (hierarchical, a DNL height, arithmetic
lossless) are a written file with its frame header patched.

    python tests/data/jpeg/make_fixtures.py   # needs cv2, PIL and x86-64
"""
import ctypes
import hashlib
import io
import json
from pathlib import Path

import cv2
import numpy as np
import PIL
from PIL import Image

HERE = Path(__file__).resolve().parent


def scene(h, w, seed):
    """A smooth gradient with a few flat discs: small files, every block busy."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w].astype(np.float32)
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                    (x + y) * 128 / max(h + w - 2, 1)], -1)
    for _ in range(3):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 12)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.randint(0, 256, 3)
    return img.astype(np.uint8)


def cmyk_scene(h, w, seed):
    return np.concatenate([scene(h, w, seed), scene(h, w, seed + 1)[..., 1:2]], -1)


def cv2_file(name, rgb, *params):
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 75, *params])
    assert ok
    (HERE / name).write_bytes(buf.tobytes())


def pil_file(name, img, **kwargs):
    bio = io.BytesIO()
    img.save(bio, "JPEG", quality=75, **kwargs)
    (HERE / name).write_bytes(bio.getvalue())


# jpeglib.h's struct jpeg_compress_struct (the libjpeg 6.2 ABI) on LP64:
# its size and the offsets of the fields set here; jpeg_CreateCompress
# checks the size and stops the process with a message on a mismatch
CINFO_SIZE, ERROR_MGR_SIZE, COMPONENT_INFO_SIZE = 520, 168, 96
OFFSET = {"image_width": 48, "image_height": 52, "input_components": 56,
          "in_color_space": 60, "data_precision": 72, "comp_info": 88, "arith_code": 260,
          "optimize_coding": 264, "restart_interval": 280}
H_SAMP, V_SAMP = 8, 12  # in jpeg_component_info
COLOR_SPACE = {"grey": 1, "rgb": 2, "cmyk": 4, "ycck": 5}


def libjpeg():
    libs = sorted((Path(PIL.__file__).parent.parent / "pillow.libs").glob("libjpeg-*.so.62*"))
    assert libs, "no libjpeg bundled with Pillow"
    return ctypes.CDLL(str(libs[0]))


def libjpeg_bytes(img, color="rgb", jpeg_color=None, arith=False, progressive=False,
                  sampling=None, lossless=None, precision=8, restart=0, quality=75):
    """`img` ((H, W) or (H, W, C) samples) compressed by libjpeg-turbo with the
    options its API offers: arithmetic coding, a JPEG colour space, sampling
    factors per component, lossless (predictor, point transform), 12 bits."""
    lib = libjpeg()
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    cinfo = (ctypes.c_char * CINFO_SIZE)()
    err = (ctypes.c_char * ERROR_MGR_SIZE)()
    lib.jpeg_std_error.restype = ctypes.c_void_p
    ctypes.c_void_p.from_buffer(cinfo, 0).value = lib.jpeg_std_error(err)
    lib.jpeg_CreateCompress(cinfo, 62, CINFO_SIZE)
    out, out_size = ctypes.c_void_p(), ctypes.c_ulong()
    lib.jpeg_mem_dest(cinfo, ctypes.byref(out), ctypes.byref(out_size))

    def put(field, value, ctype=ctypes.c_int):
        ctype.from_buffer(cinfo, OFFSET[field]).value = value

    put("image_width", w, ctypes.c_uint)
    put("image_height", h, ctypes.c_uint)
    put("input_components", 1 if img.ndim == 2 else img.shape[2])
    put("in_color_space", COLOR_SPACE[color])
    lib.jpeg_set_defaults(cinfo)
    put("data_precision", precision)
    if jpeg_color:
        lib.jpeg_set_colorspace(cinfo, COLOR_SPACE[jpeg_color])
    if lossless:
        lib.jpeg_enable_lossless(cinfo, *lossless)
    else:
        lib.jpeg_set_quality(cinfo, quality, 1)
    put("arith_code", int(arith))
    put("optimize_coding", 0)
    if progressive:
        lib.jpeg_simple_progression(cinfo)
    comp_info = ctypes.c_void_p.from_buffer(cinfo, OFFSET["comp_info"]).value
    for c, (hs, vs) in enumerate(sampling or ()):
        ctypes.c_int.from_address(comp_info + COMPONENT_INFO_SIZE * c + H_SAMP).value = hs
        ctypes.c_int.from_address(comp_info + COMPONENT_INFO_SIZE * c + V_SAMP).value = vs
    put("restart_interval", restart, ctypes.c_uint)
    lib.jpeg_start_compress(cinfo, 1)
    rows_of = img if precision == 8 else np.ascontiguousarray(img.astype(np.uint16))
    rows = (ctypes.c_void_p * h)(*[rows_of[i:i + 1].ctypes.data for i in range(h)])
    (lib.jpeg_write_scanlines if precision == 8 else lib.jpeg12_write_scanlines)(cinfo, rows, h)
    lib.jpeg_finish_compress(cinfo)
    blob = ctypes.string_at(out.value, out_size.value)
    lib.jpeg_destroy_compress(cinfo)
    return blob


def libjpeg_file(name, img, **kwargs):
    (HERE / name).write_bytes(libjpeg_bytes(img, **kwargs))


def patched_sof(blob, sof, height=None):
    """`blob` with its frame marker's code set to `sof` (and its height to
    `height`)."""
    out = bytearray(blob)
    at = next(i for i in range(len(out) - 1) if out[i] == 0xFF and 0xC0 <= out[i + 1] <= 0xCF
              and out[i + 1] not in (0xC4, 0xC8, 0xCC))
    out[at + 1] = sof
    if height is not None:
        out[at + 5:at + 7] = height.to_bytes(2, "big")
    return bytes(out)


def with_dnl(blob):
    """`blob` with a height of 0 in its frame header and its real height in
    a DNL marker after the first scan, as T.81 B.2.5 allows."""
    h = int.from_bytes(blob[blob.index(b"\xff\xc0") + 5:][:2], "big")
    zeroed = patched_sof(blob, 0xC0, height=0)
    return zeroed[:-2] + b"\xff\xdc\x00\x04" + h.to_bytes(2, "big") + b"\xff\xd9"


def main():
    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    cv2_file("cv2_444_17x31.jpg", scene(17, 31, 0), sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    cv2_file("cv2_422_33x47.jpg", scene(33, 47, 1), sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)
    cv2_file("cv2_420_33x47.jpg", scene(33, 47, 2), sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    cv2_file("cv2_440_31x17.jpg", scene(31, 17, 3), sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)
    cv2_file("cv2_411_21x35.jpg", scene(21, 35, 10), sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
    cv2_file("cv2_411_progressive_13x45.jpg", scene(13, 45, 11), sf,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    cv2_file("cv2_420_progressive_restart_41x57.jpg", scene(41, 57, 4),
             cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    cv2_file("cv2_420_restart_64x64.jpg", scene(64, 64, 5), cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    pil_file("pil_grey_progressive_23x29.jpg", Image.fromarray(scene(23, 29, 6)[..., 0]),
             progressive=True)
    exif = Image.Exif()
    exif[0x0112] = 6  # shown rotated 90 degrees clockwise
    pil_file("pil_420_exif6_21x35.jpg", Image.fromarray(scene(21, 35, 7)), exif=exif.tobytes())
    pil_file("pil_rgb_adobe_19x27.jpg", Image.fromarray(scene(19, 27, 8)), keep_rgb=True)
    pil_file("pil_cmyk_16x16.jpg", Image.fromarray(scene(16, 16, 9)).convert("CMYK"))
    libjpeg_file("lj_cmyk_h2v1_h1v2_21x35.jpg", cmyk_scene(21, 35, 12), color="cmyk",
                 sampling=[(2, 1), (1, 1), (1, 2), (1, 1)])
    libjpeg_file("lj_ycck_420_19x27.jpg", cmyk_scene(19, 27, 13), color="cmyk",
                 jpeg_color="ycck")  # libjpeg's YCCK default: Y and K 2x2
    libjpeg_file("lj_h3v1_progressive_22x37.jpg", scene(22, 37, 14),
                 sampling=[(3, 1), (1, 1), (1, 1)], progressive=True)
    libjpeg_file("lj_h2v4_21x19.jpg", scene(21, 19, 15), sampling=[(2, 4), (1, 1), (1, 1)])
    libjpeg_file("lj_arith_420_21x35.jpg", scene(21, 35, 16), arith=True)
    libjpeg_file("lj_arith_progressive_restart_23x29.jpg", scene(23, 29, 17), arith=True,
                 progressive=True, restart=2)
    libjpeg_file("lj_arith_ycck_progressive_15x22.jpg", cmyk_scene(15, 22, 18), color="cmyk",
                 jpeg_color="ycck", arith=True, progressive=True)
    lossless = libjpeg_bytes(scene(21, 35, 19), lossless=(4, 1))
    (HERE / "lj_lossless_psv4_pt1_21x35.jpg").write_bytes(lossless)
    # cv2 returns no image for these: the port refuses them
    libjpeg_file("lj_lossless_grey_17x23.jpg", scene(17, 23, 20)[..., 0], color="grey",
                 lossless=(1, 0))
    libjpeg_file("lj_12bit_21x35.jpg", scene(21, 35, 21).astype(np.uint16) * 16, precision=12)
    (HERE / "patched_arith_lossless_sof11_21x35.jpg").write_bytes(patched_sof(lossless, 0xCB))
    baseline = (HERE / "cv2_444_17x31.jpg").read_bytes()
    (HERE / "patched_hierarchical_sof5_17x31.jpg").write_bytes(patched_sof(baseline, 0xC5))
    (HERE / "patched_dnl_height_17x31.jpg").write_bytes(with_dnl(baseline))
    digests = {}
    for path in sorted(HERE.glob("*.jpg")):
        assert path.stat().st_size < 2048, path
        bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if bgr is None:
            digests[path.name] = {"refused": "ValueError"}
            continue
        rgb = np.ascontiguousarray(bgr[..., ::-1])
        digests[path.name] = {"shape": list(rgb.shape),
                              "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
