"""Bilinear point sampling of channels-last rows, as `s2d_tpu/ops/sampling.py`.

`grid_sample_rows` has `F.grid_sample` semantics (bilinear, zero padding,
align_corners=False): grid coordinates in [-1, 1], pixel centres at
half-integers, out-of-range corners weigh 0. It computes the four corners
and their weights exactly as the JAX `_corner_terms` does and sums the
weighted corner rows in the same order. Each corner is one row gather
(`index_select`), whose backward is PyTorch's own scatter-add. The TPU
sampling units (one-hot contractions, 2x2 packing) are not ported.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


def corner_terms(grid: torch.Tensor, h: int, w: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(flat index, weight) of the four bilinear corners of each point of
    `grid` (..., 2) in [-1, 1]; an out-of-range corner has weight 0 and a
    clamped (in-range) index."""
    gx, gy = grid[..., 0], grid[..., 1]
    ix = ((gx + 1.0) * w - 1.0) * 0.5
    iy = ((gy + 1.0) * h - 1.0) * 0.5
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx1 = ix - x0
    wy1 = iy - y0
    corners = []
    for xc, yc, wx, wy in (
        (x0, y0, 1.0 - wx1, 1.0 - wy1),
        (x0 + 1.0, y0, wx1, 1.0 - wy1),
        (x0, y0 + 1.0, 1.0 - wx1, wy1),
        (x0 + 1.0, y0 + 1.0, wx1, wy1),
    ):
        valid = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
        xi = xc.clamp(0, w - 1).to(torch.int64)
        yi = yc.clamp(0, h - 1).to(torch.int64)
        corners.append((yi * w + xi, wx * wy * valid))
    return corners


def grid_sample_rows(
    input_rows: torch.Tensor,  # (N, H*W, C), row-major HW
    grid: torch.Tensor,  # (N, P, 2) xy in [-1, 1]
    h: int,
    w: int,
) -> torch.Tensor:
    """(N, P, C) bilinear samples; differentiable in `input_rows` only."""
    n, hw, c = input_rows.shape
    p = grid.shape[1]
    dtype = input_rows.dtype
    flat = input_rows.reshape(n * hw, c)
    base = (torch.arange(n, device=grid.device) * hw)[:, None]
    out = None
    for idx, weight in corner_terms(grid, h, w):
        vals = flat.index_select(0, (idx + base).reshape(-1)).reshape(n, p, c)
        term = vals * weight[..., None].to(dtype)
        out = term if out is None else out + term
    return out
