"""Temporal correspondence matching, the port of `s2d_tpu/keymask/matching.py`:
keymask candidates -> instance groups.

  * per candidate keymask: track a point grid seeded in the mask (grid size
    clamp(area / 800, 25, 50)) from its seed frame over the whole video;
  * per frame and pseudo-mask, the point-mask IoU: the fraction of the
    visible (vis > 0.5) tracked points whose nearest pixel (round half to
    even, clipped to the frame) lies in the mask; above
    `matching_threshold` (0.5) the candidate matches that mask;
  * the binary (candidates, overall mask ids) match matrix is clustered by
    DBSCAN (hamming, the reference's width-adaptive eps/min_samples) into
    temporal groups, the instances;
  * per group: the frames it covers, and the one2x count of frames where
    it matches more than one mask (a noise flag).

`match_candidates` tests every candidate's points against every mask of a
frame in one numpy gather per frame; `point_mask_iou` is the one-pair form
it agrees with.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .dbscan import dbscan_hamming
from .tracker import PointTracker, grid_points_in_mask


def adaptive_grid_size(mask_area: float) -> int:
    return int(np.clip(mask_area / 800.0, 25, 50))


def _pixels(points: np.ndarray, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    xs = np.clip(points[..., 0].round().astype(int), 0, w - 1)
    ys = np.clip(points[..., 1].round().astype(int), 0, h - 1)
    return ys, xs


def point_mask_iou(
    points: np.ndarray,  # (P, 2) xy
    visibility: np.ndarray,  # (P,) in [0, 1]
    mask: np.ndarray,  # (H, W) bool
) -> float:
    """Fraction of the visible tracked points inside the mask (the
    reference restricts the mask to the rasterized point mask first, so its
    intersection over union reduces to this fraction)."""
    vis = visibility > 0.5
    if vis.sum() == 0:
        return 0.0
    ys, xs = _pixels(points[vis], *mask.shape)
    return float(mask[ys, xs].mean())


def match_candidate(
    video: np.ndarray,
    tracker: PointTracker,
    candidate_mask: np.ndarray,
    seed_frame: int,
    frame_masks: Sequence[Dict[int, np.ndarray]],  # per frame {overall_id: mask}
    matching_threshold: float = 0.5,
) -> Dict[int, bool]:
    """Track one candidate and return {overall_mask_id: True} for every
    pseudo-mask it matches."""
    return match_candidates(video, tracker, [(seed_frame, candidate_mask)], frame_masks,
                            matching_threshold)[0]


def match_candidates(
    video: np.ndarray,
    tracker: PointTracker,
    candidates: Sequence[Tuple[int, np.ndarray]],  # (seed_frame, mask)
    frame_masks: Sequence[Dict[int, np.ndarray]],
    matching_threshold: float = 0.5,
) -> List[Dict[int, bool]]:
    """All candidates of one video: the tracks in one `track_batch` call
    where the tracker has one, then per frame one gather of every
    candidate's points in every mask of that frame."""
    out: List[Dict[int, bool]] = [{} for _ in candidates]
    pts_list, idxs = [], []
    for i, (seed_frame, mask) in enumerate(candidates):
        pts = grid_points_in_mask(mask, adaptive_grid_size(mask.sum()))
        if len(pts) >= 4:
            pts_list.append(pts)
            idxs.append(i)
    if not idxs:
        return out
    if hasattr(tracker, "track_batch"):
        results = tracker.track_batch(video, pts_list, [candidates[i][0] for i in idxs])
    else:
        results = [tracker.track(video, pts, query_frame=candidates[i][0])
                   for pts, i in zip(pts_list, idxs)]
    tracks = np.concatenate([tr for tr, _ in results], axis=1)  # (T, sum P, 2)
    visible = np.concatenate([vi for _, vi in results], axis=1) > 0.5
    owner = np.repeat(np.arange(len(idxs)), [len(p) for p in pts_list])

    def per_candidate(flags):  # (sum P,) bool -> (candidates,) counts
        return np.bincount(owner, weights=flags, minlength=len(idxs))

    for fi, masks in enumerate(frame_masks):
        if not masks:
            continue
        n_vis = per_candidate(visible[fi])
        stack = np.stack([np.asarray(m, bool) for m in masks.values()])  # (M, H, W)
        ys, xs = _pixels(tracks[fi], *stack.shape[1:])
        inside = stack[:, ys, xs] & visible[fi]  # (M, sum P)
        for mid, hits in zip(masks, inside):
            # point_mask_iou: 0.0 without a visible point
            iou = np.divide(per_candidate(hits), n_vis, out=np.zeros(len(idxs)), where=n_vis > 0)
            for c in np.flatnonzero(iou > matching_threshold):
                out[idxs[c]][mid] = True
    return out


def match_matrix(all_matches: List[Dict[int, bool]], all_ids: List[int]) -> np.ndarray:
    """(num_candidates, num_overall_ids) binary match matrix."""
    id_index = {mid: i for i, mid in enumerate(all_ids)}
    mat = np.zeros((len(all_matches), len(all_ids)), bool)
    for ci, matches in enumerate(all_matches):
        for mid in matches:
            if mid in id_index:
                mat[ci, id_index[mid]] = True
    return mat


def temporal_correspondence_clustering(
    mat: np.ndarray, min_samples: int | None = None, eps: float | None = None
) -> np.ndarray:
    """DBSCAN on the binary match matrix (hamming). The reference's table
    by matrix width: > 50 -> eps 0.05, min_samples 5; < 10 -> eps 0.1,
    min_samples 3; else eps 0.1, min_samples 5. Rows with no match are
    noise (-1). Explicit `min_samples`/`eps` override the table. Returns
    labels (-1 = noise)."""
    if len(mat) == 0:
        return np.zeros((0,), np.int64)
    width = mat.shape[1]
    if width > 50:
        _eps, _min = 0.05, 5
    elif width < 10:
        _eps, _min = 0.1, 3
    else:
        _eps, _min = 0.1, 5
    labels = dbscan_hamming(mat, _eps if eps is None else eps,
                            _min if min_samples is None else min_samples)
    labels[mat.sum(axis=1) == 0] = -1
    return labels


def group_quality(mat: np.ndarray, labels: np.ndarray, frame_of_id: Sequence[int]) -> List[dict]:
    """Per group: its members, the matched overall ids, the share of the
    video's frames it covers, and one2x (frames where it matches > 1 mask)."""
    frame_of_id = np.asarray(frame_of_id)
    n_frames = max(len(set(frame_of_id.tolist())), 1)
    out = []
    for g in sorted(set(np.asarray(labels).tolist()) - {-1}):
        members = np.flatnonzero(labels == g)
        matched = mat[members].any(axis=0)  # (num_ids,)
        unique_frames, counts = np.unique(frame_of_id[matched], return_counts=True)
        out.append(
            {
                "group": int(g),
                "members": members.tolist(),
                "matched_ids": np.flatnonzero(matched).tolist(),
                "coverage": float(len(unique_frames) / n_frames),
                "one2x": int((counts > 1).sum()),
            }
        )
    return out
