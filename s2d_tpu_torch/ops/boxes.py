"""Box operations of the CutLER detector, as `s2d_tpu/ops/boxes.py`: IoU,
the detectron2 delta codec, clipping, a stable top-k and greedy box NMS.

`box_nms` is K4's function with every label equal: the candidates are
ordered by score (a stable sort, as `jnp.argsort`), their pairwise IoU is
built, and `ops/nms.greedy_mask_nms` walks it, which launches the K4 kernel
(`csrc/nms.cu`) on a CUDA tensor and runs the plain loop on a CPU tensor;
the keep mask is scattered back to the input order.

`top_k_stable` is `lax.top_k`: ties (the -inf of suppressed candidates
among them) come out lowest index first. `torch.topk` promises no order
among ties.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .nms import greedy_mask_nms

SCALE_CLAMP = math.log(1000.0 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]).clamp_min(0) * (boxes[..., 3] - boxes[..., 1]).clamp_min(0)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-9), torch.zeros_like(union))


def encode_deltas(src: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """d2 Box2BoxTransform.get_deltas(src_boxes, target_boxes)."""
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    scx = src[..., 0] + 0.5 * sw
    scy = src[..., 1] + 0.5 * sh
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    tcx = target[..., 0] + 0.5 * tw
    tcy = target[..., 1] + 0.5 * th
    return torch.stack(
        [
            (tcx - scx) / sw.clamp_min(1e-6),
            (tcy - scy) / sh.clamp_min(1e-6),
            torch.log(tw.clamp_min(1e-6) / sw.clamp_min(1e-6)),
            torch.log(th.clamp_min(1e-6) / sh.clamp_min(1e-6)),
        ],
        dim=-1,
    )


def decode_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """d2 Box2BoxTransform.apply_deltas(deltas, boxes)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    dx, dy, dw, dh = (deltas[..., i] for i in range(4))
    dw = dw.clamp(max=SCALE_CLAMP)
    dh = dh.clamp(max=SCALE_CLAMP)
    ncx = dx * w + cx
    ncy = dy * h + cy
    nw = torch.exp(dw) * w
    nh = torch.exp(dh) * h
    return torch.stack([ncx - 0.5 * nw, ncy - 0.5 * nh, ncx + 0.5 * nw, ncy + 0.5 * nh], dim=-1)


def clip_boxes(boxes: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    h, w = hw
    return torch.stack(
        [
            boxes[..., 0].clamp(0, w),
            boxes[..., 1].clamp(0, h),
            boxes[..., 2].clamp(0, w),
            boxes[..., 3].clamp(0, h),
        ],
        dim=-1,
    )


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` of a 1-D tensor: the k largest, ties lowest index first."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def box_nms(boxes: torch.Tensor, scores: torch.Tensor, threshold: float) -> torch.Tensor:
    """Greedy NMS keep-mask (N,) bool; candidates visited in score order."""
    with torch.no_grad():
        order = torch.argsort(-scores, stable=True)
        sorted_boxes = boxes[order].float()
        iou = pairwise_iou(sorted_boxes, sorted_boxes).contiguous()
        labels = torch.zeros(boxes.shape[0], dtype=torch.int64, device=boxes.device)
        keep_sorted = greedy_mask_nms(iou, labels, threshold)
        keep = torch.zeros_like(keep_sorted)
        keep[order] = keep_sorted
    return keep
