"""Object visibility extraction, the port of `s2d_tpu/keymask/visibility.py`:
per-mask point tracking -> (N, T) visibility curves.

For every (frame f, mask id m in frame f): seed a point grid inside the
mask, track it over the whole video (forward and backward) and record the
mean point visibility per frame. All seeds of a video go to the tracker
in one `track_batch` call where it has one.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from .tracker import PointTracker, grid_points_in_mask


def extract_visibility_curves(
    video: np.ndarray,  # (T, H, W, 3)
    masks_per_frame: Sequence[Dict[int, np.ndarray]],  # t -> {mask_id: (H, W) bool}
    tracker: PointTracker,
    grid_size: int = 50,
    min_points: int = 4,
) -> List[dict]:
    """Returns one record per (seed frame, mask id) with at least
    `min_points` seed points: {frame, mask_id, visibility: (T,) mean point
    visibility}."""
    seeds = []  # (frame, mask_id, points)
    for fi in range(len(video)):
        for mask_id, mask in masks_per_frame[fi].items():
            pts = grid_points_in_mask(mask, grid_size)
            if len(pts) >= min_points:
                seeds.append((fi, int(mask_id), pts))

    if hasattr(tracker, "track_batch"):
        results = tracker.track_batch(
            video, [pts for _, _, pts in seeds], [fi for fi, _, _ in seeds]
        )
    else:
        results = [tracker.track(video, pts, query_frame=fi) for fi, _, pts in seeds]

    return [
        {"frame": fi, "mask_id": mask_id, "visibility": vis.mean(axis=1).tolist()}
        for (fi, mask_id, _), (_, vis) in zip(seeds, results)
    ]


def save_visibility_json(path: str, records: List[dict]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(records, f)


def load_masks_from_color_png(png: np.ndarray) -> Dict[int, np.ndarray]:
    """Multi-colour instance PNG (H, W, C) uint8, C <= 4 -> {id: binary
    mask}: one mask per non-black colour, ids 1, 2, ... in the colours'
    lexicographic order (that of `np.unique(..., axis=0)`). A colour is
    packed into one integer first: sorting 32-bit keys is ~17x faster than
    sorting the rows (1.8 s a 720x1280 frame)."""
    png = np.asarray(png)
    if png.dtype != np.uint8 or png.ndim != 3 or png.shape[-1] > 4:
        raise ValueError(f"a colour mask PNG is (H, W, C <= 4) uint8, not {png.dtype} "
                         f"{png.shape}")
    key = np.zeros(png.shape[:2], np.uint32)
    for c in range(png.shape[-1]):
        key = (key << 8) | png[..., c]
    colors = np.unique(key)
    return {i: key == color for i, color in enumerate(colors[colors != 0], start=1)}
