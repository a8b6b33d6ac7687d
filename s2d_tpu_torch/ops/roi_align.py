"""ROIAlign on bilinear row gathers, as `s2d_tpu/ops/roi_align.py`.

detectron2/torchvision ROIAlign with aligned=True: each output cell
averages `sampling_ratio`^2 bilinear samples of the feature map inside its
box cell, sampled through `ops/sampling.grid_sample_rows` (channels-last
rows, `F.grid_sample` semantics). Differentiable in the features and in the
boxes. JAX computes it outside any Pallas kernel, so it stays PyTorch here.

`multilevel_roi_align` pools every box from every FPN level and keeps the
assigned level's result, as JAX does: the gradient reaches the other
levels as zeros, and the box coordinates get the assigned level's gradient.
"""
from __future__ import annotations

from typing import Dict

import torch

from .boxes import box_area
from .sampling import grid_sample_rows

FPN_POOL_LEVELS = ("p2", "p3", "p4", "p5")


def roi_align(
    features: torch.Tensor,  # (H, W, C) one level, channels-last
    boxes: torch.Tensor,  # (R, 4) xyxy in feature-map pixels
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Returns (R, output_size, output_size, C)."""
    h, w, c = features.shape
    r = boxes.shape[0]
    s = sampling_ratio
    n_pts = output_size * s

    x0, y0, x1, y1 = (boxes[:, i] for i in range(4))
    bw = (x1 - x0).clamp_min(1e-6)
    bh = (y1 - y0).clamp_min(1e-6)

    # aligned=True: sample points at fractional cell centres
    steps = (torch.arange(n_pts, dtype=torch.float32, device=boxes.device) + 0.5) / n_pts
    xs = x0[:, None] + steps[None, :] * bw[:, None]  # (R, n)
    ys = y0[:, None] + steps[None, :] * bh[:, None]

    gx = (xs * 2.0 + 1.0) / w - 1.0  # pixel coordinate -> align_corners=False grid
    gy = (ys * 2.0 + 1.0) / h - 1.0
    grid = torch.stack(
        [gx[:, None, :].expand(r, n_pts, n_pts), gy[:, :, None].expand(r, n_pts, n_pts)],
        dim=-1,
    ).reshape(1, r * n_pts * n_pts, 2)

    rows = features.reshape(1, h * w, c)
    sampled = grid_sample_rows(rows, grid, h, w)  # (1, R*n*n, C)
    # the cell means as two reductions over adjacent dims: one mean over the
    # strided dims (2, 4) of (R, out, s, out, s, C) is ~10x slower on the CPU
    sampled = sampled.reshape(r * output_size, s, output_size * s * c).mean(dim=1)
    return sampled.reshape(r, output_size, output_size, s, c).mean(dim=3)


def assign_boxes_to_levels(
    boxes: torch.Tensor, min_level: int = 2, max_level: int = 5, canonical: int = 224
) -> torch.Tensor:
    """FPN level (d2 heuristic): floor(4 + log2(sqrt(area) / 224)), clipped."""
    area = box_area(boxes).clamp_min(1e-6)
    lvl = torch.floor(4.0 + torch.log2(torch.sqrt(area) / canonical + 1e-8))
    return lvl.clamp(min_level, max_level).to(torch.int32)


def multilevel_roi_align(
    features: Dict[str, torch.Tensor],  # {"p2": (H2, W2, C), ..., "p5": ...}
    boxes: torch.Tensor,  # (R, 4) xyxy in image pixels
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """(R, output_size, output_size, C): every box pooled from every level,
    the assigned level's result selected."""
    levels = assign_boxes_to_levels(boxes.detach())
    out = None
    for li, name in enumerate(FPN_POOL_LEVELS):
        stride = 2 ** (li + 2)
        pooled = roi_align(features[name], boxes / stride, output_size, sampling_ratio)
        sel = (levels - 2 == li).to(pooled.dtype)[:, None, None, None]
        term = pooled * sel
        out = term if out is None else out + term
    return out
