"""Multi-scale deformable attention forward on the hand-written CUDA kernel.

`csrc/ms_deform_attn_fwd.cu` replaces the TPU kernel
`s2d_tpu/ops/ms_deform_attn_pallas.py:_fwd_kernel` (K1); the source's
header says what bounds it on the card and how it is laid out. A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain core
(`ms_deform_attn.ms_deform_attn_plain`). Forward only: the backward (K2)
belongs to the train step.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from .. import _build
from .ms_deform_attn import ms_deform_attn_plain

LAUNCHES = 0  # kernel launches since the last reset


@functools.lru_cache(maxsize=16)
def _level_info(spatial_shapes, device) -> torch.Tensor:
    """(L, 3) int32 [H, W, start] on the device, kept per shapes."""
    rows, start = [], 0
    for h, w in spatial_shapes:
        rows.append([h, w, start])
        start += h * w
    return torch.tensor(rows, dtype=torch.int32, device=device)


def ms_deform_attn_cuda(
    value: torch.Tensor,  # (B, S, M, D) f32
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # (B, Lq, M, L, P, 2) f32
    attention_weights: torch.Tensor,  # (B, Lq, M, L, P) f32
) -> torch.Tensor:
    """(B, Lq, M * D) f32, same contract as `ms_deform_attn_plain`."""
    global LAUNCHES
    if not value.is_cuda:
        return ms_deform_attn_plain(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    b, s, m, d = value.shape
    _, lq, m2, num_levels, p, two = sampling_locations.shape
    if (m2, two) != (m, 2) or sampling_locations.shape[0] != b:
        raise ValueError(f"locations {tuple(sampling_locations.shape)} vs value {tuple(value.shape)}")
    if tuple(attention_weights.shape) != (b, lq, m, num_levels, p):
        raise ValueError(f"weights {tuple(attention_weights.shape)}")
    if len(spatial_shapes) != num_levels or sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"spatial shapes {spatial_shapes} vs S={s}, L={num_levels}")
    for name, t in (("value", value), ("locations", sampling_locations),
                    ("weights", attention_weights)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != value.device:
            raise ValueError(f"{name} on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((b, lq, m * d), dtype=torch.float32, device=value.device)
    lib = _build.library()
    rc = lib.s2d_msda_fwd(
        value.data_ptr(), _level_info(tuple(map(tuple, spatial_shapes)), value.device).data_ptr(),
        sampling_locations.data_ptr(), attention_weights.data_ptr(), out.data_ptr(),
        b, s, m, d, lq, num_levels, p, _build.stream_handle(value),
    )
    _build.check(rc, "s2d_msda_fwd")
    LAUNCHES += 1
    return out
