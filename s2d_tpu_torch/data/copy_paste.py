"""Copy-paste augmentation for video clips, as `s2d_tpu/data/copy_paste.py`
(`copy_paste_clip`, `propagate_sparse_masks`, `apply_clip_copy_paste`),
with the port's own resizes (`transforms.py`) in place of cv2.

Instances of a source clip are resized and shifted by ONE shared transform
(the whole source canvas to ratio x the destination size, at one random
offset) and pasted into every frame of a destination clip. The paste is
rejected as a whole when, at frame 0, a pasted instance covers at least
half of an existing one (intersection over the existing instance's area).
Pasted pixels overwrite the destination image; existing instances are
carved and dropped when carved to nothing. A host-side numpy transform on
the loader thread, before collation (DATALOADER.COPY_PASTE).

`copy_paste_image` is the CutLER trainer's image copy-paste, on one mapped
image (a uint8 canvas in the port's train CLI, which normalizes on the
device; JAX pastes the normalized float canvas, so the rescaled source's
pixels round to uint8 here).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .transforms import resize_linear, resize_nearest


def copy_paste_clip(
    rng: np.random.RandomState,
    dst: Dict[str, np.ndarray],  # mapper sample: image (T,H,W,3), masks (N,T,H,W), valid (N,)
    src: Dict[str, np.ndarray],
    rate: float = 1.0,
    min_ratio: float = 0.8,
    max_ratio: float = 1.0,
    reject_ioy: float = 0.5,
    random_num: bool = False,
) -> Dict[str, np.ndarray]:
    """Paste src's instances into dst. Candidates are capped at dst's free
    slots before compositing, so every pasted pixel gets a slot."""
    if rng.rand() >= rate:
        return dst
    t, h, w, _ = dst["image"].shape

    src_ids = np.flatnonzero(src["valid"])
    if len(src_ids) == 0:
        return dst
    if random_num:
        k = rng.randint(1, len(src_ids) + 1)
        src_ids = rng.choice(src_ids, k, replace=False)
    src_ids = src_ids[: int((~dst["valid"]).sum())]
    if len(src_ids) == 0:
        return dst

    st = min(t, src["image"].shape[0])
    ratio = rng.uniform(min_ratio, max_ratio)
    nh, nw = max(int(ratio * h), 1), max(int(ratio * w), 1)
    dy = rng.randint(0, max(h - nh, 0) + 1)
    dx = rng.randint(0, max(w - nw, 0) + 1)

    pasted = np.zeros((len(src_ids), t, h, w), bool)
    pasted_rgb = np.zeros((t, h, w, 3), dst["image"].dtype)
    for fi in range(st):
        rgb = resize_linear(np.ascontiguousarray(src["image"][fi]), (nh, nw))
        pasted_rgb[fi, dy: dy + nh, dx: dx + nw] = rgb[: h - dy, : w - dx]
    moved = resize_nearest(src["masks"][src_ids, :st], (nh, nw))
    pasted[:, :st, dy: dy + nh, dx: dx + nw] = moved[..., : h - dy, : w - dx]

    nonzero = pasted.sum(axis=(1, 2, 3)) > 0
    pasted = pasted[nonzero]
    if pasted.shape[0] == 0:
        return dst

    existing = dst["masks"][dst["valid"]]
    if existing.shape[0]:
        inter = (pasted[:, None, 0] & existing[None, :, 0]).sum(axis=(-1, -2)).astype(np.float64)
        area_y = np.maximum(existing[:, 0].sum(axis=(-1, -2)).astype(np.float64), 1.0)
        if (inter / area_y).max() >= reject_ioy:
            return dst

    alpha = pasted.any(axis=0)  # (T, H, W)
    image = np.where(alpha[..., None], pasted_rgb, dst["image"])
    masks = dst["masks"].copy()
    masks &= ~alpha[None]
    valid = dst["valid"] & (masks.sum(axis=(1, 2, 3)) > 0)
    free = np.flatnonzero(~valid)
    for j in range(pasted.shape[0]):
        masks[free[j]] = pasted[j]
        valid[free[j]] = True

    out = dict(dst)
    out.update(image=image, masks=masks, valid=valid)
    return out


def propagate_sparse_masks(
    masks: np.ndarray,  # (N, T, H, W) bool instance tracks
    valid: np.ndarray,  # (N,) track validity
    rng: np.random.RandomState,
    max_shift: int = 2,
) -> np.ndarray:
    """Forward-fill each valid track: a frame where a track seen before has
    no mask gets the latest mask, shifted by a +-max_shift pixel jitter."""
    out = masks.copy()
    n, t, h, w = out.shape
    for i in np.flatnonzero(valid):
        last = None
        for fi in range(t):
            if out[i, fi].any():
                last = out[i, fi]
            elif last is not None:
                dy = rng.randint(-max_shift, max_shift + 1) if max_shift else 0
                dx = rng.randint(-max_shift, max_shift + 1) if max_shift else 0
                shifted = np.zeros((h, w), bool)
                ys, xs = np.nonzero(last)
                ys2, xs2 = ys + dy, xs + dx
                keep = (ys2 >= 0) & (ys2 < h) & (xs2 >= 0) & (xs2 < w)
                shifted[ys2[keep], xs2[keep]] = True
                out[i, fi] = shifted
                last = shifted
    return out


def apply_clip_copy_paste(
    samples: list,
    rng: np.random.RandomState,
    rate: float = 1.0,
    random_num: bool = False,
    min_ratio: float = 0.8,
    max_ratio: float = 1.0,
    densify_sparse: bool = False,
    max_shift: int = 2,
) -> list:
    """Batch-level clip copy-paste: every member takes the reversed batch's
    member as its source, behind one rate draw. With densify_sparse a
    triggered member is forward-filled instead of pasted; otherwise it is
    pasted, then forward-filled."""
    out = []
    for dst, src in zip(samples, samples[::-1]):
        triggered = rng.rand() < rate and bool(np.asarray(src["valid"]).any())
        if not triggered:
            out.append(dst)
            continue
        if densify_sparse:
            new = dict(dst)
            new["masks"] = propagate_sparse_masks(dst["masks"], dst["valid"], rng, max_shift)
            out.append(new)
            continue
        new = dict(copy_paste_clip(rng, dst, src, rate=1.0, min_ratio=min_ratio,
                                   max_ratio=max_ratio, random_num=random_num))
        new["masks"] = propagate_sparse_masks(new["masks"], new["valid"], rng, max_shift)
        out.append(new)
    return out


def _boxes_from_masks(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) bool -> (N, 4) xyxy boxes (zeros for empty masks)."""
    n = masks.shape[0]
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        ys, xs = np.nonzero(masks[i])
        if len(ys):
            boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return boxes


def copy_paste_image(
    rng: np.random.RandomState,
    dst: Dict[str, np.ndarray],  # cutler sample: image (S,S,3), boxes, labels, valid, masks (N,S,S)
    src: Dict[str, np.ndarray],
    rate: float = 1.0,
    min_ratio: float = 0.5,
    max_ratio: float = 1.0,
    reject_ioy: float = 0.5,
    random_num: bool = True,
) -> Dict[str, np.ndarray]:
    """Image copy-paste for the CutLER trainer.

    The reference's `copy_and_paste` (cutler/engine/train_loop.py, applied
    per step in `run_step`): the whole source canvas is rescaled by a ratio of the
    DESTINATION size, randomly placed, and the selected source instances'
    pixels composite over the destination; copied instances whose IoY with
    any existing instance exceeds 0.5 are dropped; surviving existing
    instances are carved where pasted pixels cover them and zero-area
    leftovers invalidated; boxes are recomputed from the merged masks.
    Works on the mapper's canvas, uint8 or normalized float32."""
    if rng.rand() >= rate:
        return dst
    src_ids = np.flatnonzero(src["valid"])
    if len(src_ids) == 0:
        return dst
    if random_num:
        k = 1 if len(src_ids) == 1 else rng.randint(1, len(src_ids))
        src_ids = rng.choice(src_ids, k, replace=False)

    s = dst["image"].shape[0]
    ratio = rng.uniform(min_ratio, max_ratio)
    ns = max(int(ratio * s), 1)
    dy = rng.randint(0, s - ns + 1)
    dx = rng.randint(0, s - ns + 1)

    src_img = resize_linear(src["image"], (ns, ns))
    canvas_img = np.zeros_like(dst["image"])
    canvas_img[dy:dy + ns, dx:dx + ns] = src_img

    pasted = np.zeros((len(src_ids), s, s), bool)
    for j, sid in enumerate(src_ids):
        m = resize_nearest(src["masks"][sid], (ns, ns))
        pasted[j, dy:dy + ns, dx:dx + ns] = m

    # IoY rejection against existing instances (intersection / pasted area)
    existing = dst["masks"][dst["valid"]]
    keep = np.ones(len(src_ids), bool)
    if existing.shape[0]:
        inter = (pasted[:, None] & existing[None]).sum((-1, -2)).astype(np.float64)
        area_y = np.maximum(existing.sum((-1, -2)).astype(np.float64), 1.0)
        keep = (inter / area_y).max(axis=1) < reject_ioy
    pasted = pasted[keep]
    kept_ids = src_ids[keep]
    # Cap at the free annotation slots BEFORE carving (carving can only
    # free more), so every composited object gets a label — compositing
    # unassignable masks would paint unannotated objects that occlude
    # labeled ones. (The reference appends Instances unboundedly; the
    # fixed-slot layout must truncate instead.)
    n_free = int((~dst["valid"]).sum())
    pasted = pasted[:n_free]
    kept_ids = kept_ids[:n_free]
    if pasted.shape[0] == 0:
        return dst

    alpha = pasted.any(axis=0)
    image = np.where(alpha[..., None], canvas_img, dst["image"])
    masks = dst["masks"].copy()
    masks &= ~alpha  # carve occluded pixels out of existing instances
    valid = dst["valid"] & (masks.sum((-1, -2)) > 0)
    labels = dst["labels"].copy()

    free = np.flatnonzero(~valid)
    for j in range(min(len(free), pasted.shape[0])):
        masks[free[j]] = pasted[j]
        valid[free[j]] = True
        labels[free[j]] = src["labels"][kept_ids[j]]

    out = dict(dst)
    out.update(
        image=image, masks=masks, valid=valid, labels=labels,
        boxes=np.where(valid[:, None], _boxes_from_masks(masks), 0.0).astype(np.float32),
    )
    return out
