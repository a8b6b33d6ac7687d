"""Multi-scale + hflip test-time augmentation for the CutLER R-CNN, as
`s2d_tpu/evaluation/tta_rcnn.py` (detectron2's GeneralizedRCNNWithTTA,
TEST.AUG.ENABLED):

  1. per augmentation (each TEST.AUG.MIN_SIZES scale, and its hflip): the
     cascade inference, its boxes mapped back to the original image
     (resize and flip inverted) and clipped to it;
  2. one class-wise NMS over every augmentation's detections (box NMS on
     class-offset boxes: K4 on the card, up to 1800 candidates at the
     defaults) and the top DETECTIONS_PER_IMAGE;
  3. masks: per augmentation the mask head at the merged boxes mapped into
     that augmentation's frame, a flipped one's box-frame masks flipped
     back, the probabilities averaged.

Every augmentation shares one padded canvas,
round_up(min(MAX_SIZE, 2 * max(MIN_SIZES)), 32). The resizes are
`data/transforms.resize_linear` on float32 (within 1e-3 of cv2's).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.boxes import box_nms, top_k_stable


def tta_canvas_size(min_sizes: Tuple[int, ...], max_size: int) -> int:
    s = min(max_size, 2 * max(min_sizes))
    return -(-s // 32) * 32


def tta_variants(img: np.ndarray, min_sizes: Tuple[int, ...], max_size: int, flip: bool,
                 pixel_mean, pixel_std) -> Tuple[np.ndarray, List[Dict]]:
    """img (H, W, 3) float32 unnormalized -> ((A, S, S, 3) normalized
    canvases, per augmentation {scale, flipped, nw})."""
    from ..data.transforms import resize_linear

    h, w = img.shape[:2]
    s = tta_canvas_size(min_sizes, max_size)
    canvases, metas = [], []
    mean = np.asarray(pixel_mean, np.float32)
    std = np.asarray(pixel_std, np.float32)
    for ms in min_sizes:
        scale = min(ms / min(h, w), s / max(h, w))
        nh, nw = int(round(h * scale)), int(round(w * scale))
        resized = resize_linear(img, (nh, nw))
        for flipped in (False, True) if flip else (False,):
            view = resized[:, ::-1] if flipped else resized
            canvas = np.zeros((s, s, 3), np.float32)
            canvas[:nh, :nw] = view
            canvases.append((canvas - mean) / std)
            metas.append({"scale": scale, "flipped": flipped, "nw": nw})
    return np.stack(canvases), metas


def boxes_to_original(boxes: np.ndarray, meta: Dict) -> np.ndarray:
    """(K, 4) xyxy boxes of an augmentation's frame -> original image."""
    b = boxes.copy()
    if meta["flipped"]:
        x0 = meta["nw"] - b[:, 2]
        x1 = meta["nw"] - b[:, 0]
        b[:, 0], b[:, 2] = x0, x1
    return b / meta["scale"]


def boxes_to_aug(boxes: np.ndarray, meta: Dict) -> np.ndarray:
    """The inverse of boxes_to_original."""
    b = boxes * meta["scale"]
    if meta["flipped"]:
        x0 = meta["nw"] - b[:, 2]
        x1 = meta["nw"] - b[:, 0]
        b = b.copy()
        b[:, 0], b[:, 2] = x0, x1
    return b


def merge_detections(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                     valid: torch.Tensor, *, nms_thresh: float, topk: int):
    """One per-class NMS over the pooled detections and the top `topk`. The
    classes are told apart by offsetting each class's boxes by a span past
    every box, after translating so that every coordinate is >= 0 (IoU is
    translation-invariant), so one class-agnostic NMS does them all."""
    neg_inf = torch.full_like(scores, float("-inf"))
    scores = torch.where(valid, scores, neg_inf)
    lo = torch.where(valid[:, None], boxes, torch.full_like(boxes, float("inf"))).min()
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    b0 = boxes - lo
    span = torch.where(valid[:, None], b0, torch.zeros_like(b0)).max() + 1.0
    shifted = b0 + (classes.to(boxes.dtype) * span)[:, None]
    keep = box_nms(shifted, scores, nms_thresh) & valid
    scores = torch.where(keep, scores, neg_inf)
    top_scores, idx = top_k_stable(scores, min(topk, scores.shape[0]))
    out_valid = torch.isfinite(top_scores)
    return boxes[idx], torch.where(out_valid, top_scores, torch.zeros_like(top_scores)), \
        classes[idx], out_valid


def tta_inference(img: np.ndarray, *, infer_boxes, infer_masks, min_sizes: Tuple[int, ...],
                  max_size: int, flip: bool, pixel_mean, pixel_std, nms_thresh: float,
                  topk: int):
    """The TTA sweep of one image (H, W, 3) float32 unnormalized.

    infer_boxes(canvas (1, S, S, 3) float32 numpy) -> (boxes, scores,
    classes, valid) tensors; infer_masks(canvas, boxes (K, 4) numpy) -> (K,
    m, m) probabilities, or None for boxes only. The merge runs on the
    device of infer_boxes' tensors (K4 on the card). Returns (boxes, scores, classes, valid) tensors in original-image
    coordinates, and with infer_masks the averaged (K, m, m) numpy
    probabilities."""
    canvases, metas = tta_variants(img, min_sizes, max_size, flip, pixel_mean, pixel_std)
    h0, w0 = img.shape[:2]
    all_boxes, all_scores, all_classes, all_valid = [], [], [], []
    device = None
    for canvas, meta in zip(canvases, metas):
        detections = infer_boxes(canvas[None])
        device = detections[0].device
        b, sc, cl, v = (x.cpu().numpy() for x in detections)
        ob = boxes_to_original(b, meta)
        ob[:, 0::2] = np.clip(ob[:, 0::2], 0.0, float(w0))
        ob[:, 1::2] = np.clip(ob[:, 1::2], 0.0, float(h0))
        all_boxes.append(ob)
        all_scores.append(sc)
        all_classes.append(cl)
        all_valid.append(v)
    boxes, scores, classes, valid = merge_detections(
        *(torch.from_numpy(np.concatenate(x)).to(device)
          for x in (all_boxes, all_scores, all_classes, all_valid)),
        nms_thresh=nms_thresh, topk=topk)
    if infer_masks is None:
        return boxes, scores, classes, valid
    boxes_np = boxes.cpu().numpy()
    probs = None
    for canvas, meta in zip(canvases, metas):
        p = np.asarray(infer_masks(canvas[None], boxes_to_aug(boxes_np, meta)))
        if meta["flipped"]:
            p = p[:, :, ::-1]  # a box-frame mask flips back with its box
        probs = p if probs is None else probs + p
    return boxes, scores, classes, valid, probs / len(metas)
