"""Bilinear resize with align_corners=False, as `s2d_tpu/ops/resize.py:94`.

JAX computes this outside any Pallas kernel (two 1-D interpolation
matmuls, which reproduce torch's half-pixel, edge-clamped sampling), so the
port calls `F.interpolate` directly.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def interpolate_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize the trailing two dims of `x` (..., H, W) to `size` (H', W')."""
    out_h, out_w = size
    *lead, h, w = x.shape
    if (h, w) == (out_h, out_w):
        return x
    flat = x.reshape(-1, 1, h, w)
    out = F.interpolate(flat, size=(out_h, out_w), mode="bilinear", align_corners=False)
    return out.reshape(*lead, out_h, out_w)
