"""Multi-scale deformable attention: the plain PyTorch core and its dispatch.

Counterpart of `s2d_tpu/ops/ms_deform_attn.py`. The plain core samples each
level with `F.grid_sample` (align_corners=False, zero padding) and sums the
samples weighted by the attention weights, as the JAX XLA path
(`_ms_deform_attn_xla`) and the reference's own torch oracle do. It is the
twin of the CUDA kernel in `ms_deform_attn_cuda.py` (K1) and what that
wrapper runs for a tensor on the CPU.

The TPU-only sampling variants (one-hot / packed units, `orient`, `q_tile`)
have no counterpart here.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def ms_deform_attn_plain(
    value: torch.Tensor,  # (B, S, M, D)
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # (B, Lq, M, L, P, 2) xy in [0, 1]
    attention_weights: torch.Tensor,  # (B, Lq, M, L, P)
) -> torch.Tensor:
    """(B, Lq, M * D) attended features, `F.grid_sample` per level."""
    b, s, m, d = value.shape
    _, lq, _, num_levels, p, _ = sampling_locations.shape
    assert len(spatial_shapes) == num_levels
    assert sum(h * w for h, w in spatial_shapes) == s
    samples = []
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        # (B, HW, M, D) -> (B*M, D, H, W)
        v = value[:, start : start + h * w].permute(0, 2, 3, 1).reshape(b * m, d, h, w)
        # (B, Lq, M, P, 2) -> (B*M, Lq, P, 2) in [-1, 1]
        grid = 2.0 * sampling_locations[:, :, :, lid] - 1.0
        grid = grid.permute(0, 2, 1, 3, 4).reshape(b * m, lq, p, 2)
        samples.append(
            F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
        )  # (B*M, D, Lq, P)
        start += h * w
    stacked = torch.stack(samples, dim=-2)  # (B*M, D, Lq, L, P)
    weights = attention_weights.permute(0, 2, 1, 3, 4).reshape(b * m, 1, lq, num_levels, p)
    out = (stacked * weights).sum(dim=(-1, -2))  # (B*M, D, Lq)
    return out.reshape(b, m, d, lq).permute(0, 3, 1, 2).reshape(b, lq, m * d)


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    *,
    impl: str = "plain",
) -> torch.Tensor:
    """impl: "plain" (this module's core, on any device) or "cuda" (the K1
    kernel for CUDA tensors; its wrapper takes the plain core on the CPU)."""
    if impl == "cuda":
        from .ms_deform_attn_cuda import ms_deform_attn_cuda

        return ms_deform_attn_cuda(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    if impl != "plain":
        raise ValueError(f"unknown MSDA impl {impl!r}")
    return ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights)
