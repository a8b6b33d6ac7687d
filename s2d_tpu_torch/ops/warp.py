"""Affine mask warping for the disentangled distillation view, as
`s2d_tpu/ops/warp.py`: the teacher's masks, predicted in the primary view,
are resampled into the distillation view with the per-frame affine the
mapper recorded (primary pixels -> distill pixels). Bilinear samples with
zeros outside (`ops/sampling.grid_sample_rows`, `F.grid_sample`'s
convention), binarized at 0.5.
"""
from __future__ import annotations

import torch

from .sampling import grid_sample_rows


def warp_masks_affine(
    masks: torch.Tensor,  # (B, N, T, H, W) bool or float, primary view
    affine: torch.Tensor,  # (B, T, 3, 3): primary px -> distill px
    binarize: bool = True,
) -> torch.Tensor:
    """The masks resampled into the distill view on the same canvas: (B, N,
    T, H, W) bool, or the bilinear values (float32) with binarize=False.
    One frame at a time, so that one frame's (H*W, N) rows are alive."""
    b, n, t, h, w = masks.shape
    dev = masks.device
    inv = torch.linalg.inv(affine.float())  # distill px -> primary px
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    out = torch.empty((b, n, t, h, w), dtype=torch.bool if binarize else torch.float32,
                      device=dev)
    for bi in range(b):
        for ti in range(t):
            m = inv[bi, ti]
            sx, sy, sz = (m[k, 0] * xs + m[k, 1] * ys + m[k, 2] for k in range(3))
            sz = sz.clamp_min(1e-8)
            # pixel centres at integers -> align_corners=False coordinates
            gx = (sx / sz + 0.5) / w * 2.0 - 1.0
            gy = (sy / sz + 0.5) / h * 2.0 - 1.0
            rows = masks[bi, :, ti].float().reshape(n, h * w).T.contiguous()[None]
            warped = grid_sample_rows(rows, torch.stack([gx, gy], dim=-1)[None], h, w)[0]
            warped = warped.T.reshape(n, h, w)
            out[bi, :, ti] = warped > 0.5 if binarize else warped
    return out
