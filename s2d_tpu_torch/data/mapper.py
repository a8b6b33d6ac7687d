"""The eval mapper: a YTVIS video record -> its frames at the test size.

Counterpart of `s2d_tpu/data/mapper.py:ClipMapper` with is_train=False and
its resize (`s2d_tpu/data/augment.py:resize_shortest_edge`, `_resize`):
every frame of the video is read as RGB and resized so that its shortest
edge is MIN_SIZE_TEST, capped at MAX_SIZE_TEST, bilinear (cv2
INTER_LINEAR), giving uint8 (T, H, W, 3). The evaluator scores against the
record's own RLEs, so the eval mapper decodes no target masks. The train
mapper waits for the train CLI (ROADMAP queue 1).

cv2 or PIL is imported only where a frame is read from an image file, and
cv2 where a frame is resized, as the JAX mapper requires it: a host
without cv2 passes its frames to `evaluate_dataset(mapper=...)`.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np


def resize_shortest_edge(h: int, w: int, short: int, max_size: int) -> Tuple[int, int]:
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def load_image_robust(path: str, retries: int = 3, backoff: float = 0.5) -> np.ndarray:
    """Read an RGB image with retry and exponential backoff (network
    filesystems flake), by cv2 and else by PIL, as the JAX mapper."""
    cv2 = _cv2()
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if cv2 is None and Image is None:
        raise ImportError(
            f"reading frame {path!r} needs cv2 (opencv-python) or PIL (pillow); "
            "neither is installed. Pass frames to evaluate_dataset(mapper=...) instead"
        )
    last_err: Exception | None = None
    for attempt in range(retries):
        if cv2 is not None:
            img = cv2.imread(path, cv2.IMREAD_COLOR)
            if img is not None:
                return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if Image is not None:
            try:
                with Image.open(path) as im:
                    return np.asarray(im.convert("RGB"))
            except OSError as err:
                last_err = err
        time.sleep(backoff * (2 ** attempt))
    raise FileNotFoundError(f"could not read {path!r}: {last_err}")


def resize_frames(frames: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, *size_hw, 3) uint8, bilinear."""
    if tuple(frames.shape[1:3]) == tuple(size_hw):
        return frames
    cv2 = _cv2()
    if cv2 is None:
        raise ImportError(
            f"resizing frames of {tuple(frames.shape[1:3])} to {tuple(size_hw)} needs cv2 "
            "(opencv-python), as the JAX mapper does. Pass frames at the test size to "
            "evaluate_dataset(mapper=...) instead"
        )
    return np.stack([
        cv2.resize(f, (size_hw[1], size_hw[0]), interpolation=cv2.INTER_LINEAR)
        for f in frames
    ])


class EvalMapper:
    """record -> {"video_id", "image": (T, H, W, 3) uint8, "height", "width",
    "selected_idx"}: all frames, resized to the test size."""

    def __init__(self, min_size_test: int = 360, max_size_test: int = 1333):
        self.min_size_test = min_size_test
        self.max_size_test = max_size_test

    def __call__(self, record: dict) -> dict:
        frames: List[np.ndarray] = [load_image_robust(f) for f in record["file_names"]]
        h, w = frames[0].shape[:2]
        size = resize_shortest_edge(h, w, self.min_size_test, self.max_size_test)
        return {
            "video_id": record["video_id"],
            "image": resize_frames(np.stack(frames), size),
            "height": record["height"],
            "width": record["width"],
            "selected_idx": list(range(record["length"])),
        }
