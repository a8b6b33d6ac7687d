"""Writes the JPEG fixtures of tests/test_torch_jpeg.py and chip_smoke.py
phase 16 with cv2 and PIL, and `digests.json`: per file, the SHA-256 of
`cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]` (C order) and its shape, or
the exception the port's reader must raise for a kind it refuses.

    python tests/data/jpeg/make_fixtures.py   # needs cv2 and PIL
"""
import hashlib
import io
import json
from pathlib import Path

import cv2
import numpy as np
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


def cv2_file(name, rgb, *params):
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 75, *params])
    assert ok
    (HERE / name).write_bytes(buf.tobytes())


def pil_file(name, img, **kwargs):
    bio = io.BytesIO()
    img.save(bio, "JPEG", quality=75, **kwargs)
    (HERE / name).write_bytes(bio.getvalue())


def main():
    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    cv2_file("cv2_444_17x31.jpg", scene(17, 31, 0), sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    cv2_file("cv2_422_33x47.jpg", scene(33, 47, 1), sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)
    cv2_file("cv2_420_33x47.jpg", scene(33, 47, 2), sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    cv2_file("cv2_440_31x17.jpg", scene(31, 17, 3), sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)
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
    digests = {}
    for path in sorted(HERE.glob("*.jpg")):
        assert path.stat().st_size < 2048, path
        if "cmyk" in path.name:
            digests[path.name] = {"refused": "ValueError"}
            continue
        rgb = np.ascontiguousarray(cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1])
        digests[path.name] = {"shape": list(rgb.shape),
                              "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
