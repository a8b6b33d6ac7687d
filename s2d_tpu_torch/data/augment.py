"""Clip augmentations, as `s2d_tpu/data/augment.py`, in numpy with the
port's own transforms (`transforms.py`) where the JAX package calls cv2.

  * RandomCrop "absolute_range", per frame;
  * ResizeShortestEdge "choice_by_clip": one target size a clip, bilinear
    for frames, nearest for masks;
  * RandomFlip "flip_by_clip": one coin a clip;
  * RandomBrightness / RandomContrast / RandomSaturation (0.9, 1.1) and
    RandomRotation in [-15, 15] about a centre drawn in [0.4, 0.6] of the
    image, per frame (expand=False).

The draws come from the caller's `np.random.RandomState` in the JAX
module's order, so one seed gives the same crop, scale, flip, photometric
weights and angle on both.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .transforms import resize_linear, resize_nearest, rotation_matrix_2d, warp_affine


@dataclasses.dataclass
class ClipAugConfig:
    min_sizes: Sequence[int] = (360, 480)
    max_size: int = 1333
    flip_prob: float = 0.5
    crop_enabled: bool = False
    crop_range: Tuple[int, int] = (600, 720)
    brightness: bool = False
    contrast: bool = False
    saturation: bool = False
    rotation: bool = False


def resize_shortest_edge(h: int, w: int, short: int, max_size: int) -> Tuple[int, int]:
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def _affine_translate(dx: float, dy: float) -> np.ndarray:
    m = np.eye(3)
    m[0, 2], m[1, 2] = dx, dy
    return m


def _affine_scale(sx: float, sy: float) -> np.ndarray:
    return np.diag([sx, sy, 1.0])


def _affine_hflip(w: int) -> np.ndarray:
    m = np.eye(3)
    m[0, 0], m[0, 2] = -1.0, w - 1.0
    return m


def _resize_masks(masks: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """(N, T, H, W) bool -> (N, T, *size_hw), nearest."""
    if not masks.shape[0]:
        return np.zeros((0, masks.shape[1], *size_hw), bool)
    return np.ascontiguousarray(resize_nearest(masks, size_hw))


def augment_clip(
    rng: np.random.RandomState,
    frames: List[np.ndarray],  # T x (H, W, 3) uint8 RGB
    masks: Optional[np.ndarray],  # (N, T, H, W) bool or None
    cfg: ClipAugConfig,
    return_affines: bool = False,
):
    """The train augmentation (the eval resize is `mapper.EvalMapper`'s).
    Returns (frames, masks) or, with return_affines, (frames, masks,
    affines (T, 3, 3)), each affine mapping original pixel coordinates
    (x, y, 1) to augmented ones. Frames come back float32 in [0, 255]."""
    t = len(frames)
    h, w = frames[0].shape[:2]
    affines = [np.eye(3) for _ in range(t)]
    out_frames = list(frames)
    out_masks = masks

    # per-frame random crop (absolute_range)
    if cfg.crop_enabled:
        new_frames, new_masks = [], []
        ch = min(rng.randint(cfg.crop_range[0], cfg.crop_range[1] + 1), h)
        cw = min(rng.randint(cfg.crop_range[0], cfg.crop_range[1] + 1), w)
        for i in range(t):
            y0 = rng.randint(0, h - ch + 1)
            x0 = rng.randint(0, w - cw + 1)
            new_frames.append(out_frames[i][y0: y0 + ch, x0: x0 + cw])
            affines[i] = _affine_translate(-x0, -y0) @ affines[i]
            if out_masks is not None:
                new_masks.append(out_masks[:, i, y0: y0 + ch, x0: x0 + cw])
        out_frames = new_frames
        if out_masks is not None:
            out_masks = (np.stack(new_masks, axis=1) if out_masks.shape[0]
                         else np.zeros((0, t, ch, cw), bool))
        h, w = ch, cw

    # clip-consistent resize
    short = int(rng.choice(list(cfg.min_sizes)))
    nh, nw = resize_shortest_edge(h, w, short, cfg.max_size)
    out_frames = [resize_linear(np.ascontiguousarray(f), (nh, nw)) for f in out_frames]
    affines = [_affine_scale(nw / w, nh / h) @ a for a in affines]
    if out_masks is not None:
        out_masks = _resize_masks(out_masks, (nh, nw))
    h, w = nh, nw

    # clip-consistent horizontal flip
    if rng.rand() < cfg.flip_prob:
        out_frames = [f[:, ::-1] for f in out_frames]
        affines = [_affine_hflip(w) @ a for a in affines]
        if out_masks is not None and out_masks.shape[0]:
            out_masks = out_masks[:, :, :, ::-1]

    # per-frame photometric + rotation
    if cfg.rotation and out_masks is not None and out_masks.shape[0]:
        out_masks = np.array(out_masks)  # writable: rotation fills frames in place
    for i in range(t):
        img = out_frames[i].astype(np.float32)
        if cfg.brightness:
            img = img * rng.uniform(0.9, 1.1)
        if cfg.contrast:
            wgt = rng.uniform(0.9, 1.1)
            img = img * wgt + img.mean() * (1.0 - wgt)
        if cfg.saturation:
            wgt = rng.uniform(0.9, 1.1)
            grey = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
            img = img * wgt + grey[..., None] * (1.0 - wgt)
        if cfg.rotation:
            angle = rng.uniform(-15.0, 15.0)
            cx = rng.uniform(0.4, 0.6) * w
            cy = rng.uniform(0.4, 0.6) * h
            mat = rotation_matrix_2d((cx, cy), angle, 1.0)
            affines[i] = np.vstack([mat, [0.0, 0.0, 1.0]]) @ affines[i]
            img = warp_affine(np.ascontiguousarray(img), mat)
            if out_masks is not None and out_masks.shape[0]:
                out_masks[:, i] = np.moveaxis(
                    warp_affine(np.moveaxis(out_masks[:, i], 0, -1), mat), -1, 0)
        out_frames[i] = np.clip(img, 0, 255)

    if out_masks is not None:
        out_masks = np.ascontiguousarray(out_masks)
    if return_affines:
        return out_frames, out_masks, np.stack(affines)
    return out_frames, out_masks
