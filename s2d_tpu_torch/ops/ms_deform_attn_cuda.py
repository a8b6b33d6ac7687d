"""Multi-scale deformable attention on the hand-written CUDA kernels.

`csrc/ms_deform_attn_fwd.cu` replaces the TPU kernel
`s2d_tpu/ops/ms_deform_attn_pallas.py:_fwd_kernel` (K1) and
`csrc/ms_deform_attn_bwd.cu` its `_bwd_kernel` with the custom VJP's chain
rule (K2); each source's header says what bounds it on the card and how it
is laid out. `ms_deform_attn_cuda` is differentiable: on a CUDA tensor its
forward launches K1 and its backward K2 (a `torch.autograd.Function`), or
they raise. A CPU tensor takes the plain core
(`ms_deform_attn.ms_deform_attn_plain`), whose backward is autograd through
`F.grid_sample`: the plain version of K2 is `ms_deform_attn_bwd_plain`.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from .. import _build
from .ms_deform_attn import ms_deform_attn_plain

LAUNCHES = 0  # K1 launches since the last reset
BWD_LAUNCHES = 0  # K2 launches since the last reset


@functools.lru_cache(maxsize=16)
def _level_info(spatial_shapes) -> torch.Tensor:
    """(L, 3) int32 [H, W, start] in host memory, where K1's and K2's
    launchers read it, kept per shapes."""
    rows, start = [], 0
    for h, w in spatial_shapes:
        rows.append([h, w, start])
        start += h * w
    return torch.tensor(rows, dtype=torch.int32)


def _check(value, spatial_shapes, sampling_locations, attention_weights, *extra):
    b, s, m, d = value.shape
    _, lq, m2, num_levels, p, two = sampling_locations.shape
    if (m2, two) != (m, 2) or sampling_locations.shape[0] != b:
        raise ValueError(f"locations {tuple(sampling_locations.shape)} vs value {tuple(value.shape)}")
    if tuple(attention_weights.shape) != (b, lq, m, num_levels, p):
        raise ValueError(f"weights {tuple(attention_weights.shape)}")
    if len(spatial_shapes) != num_levels or sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"spatial shapes {spatial_shapes} vs S={s}, L={num_levels}")
    for name, t in (("value", value), ("locations", sampling_locations),
                    ("weights", attention_weights), *extra):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != value.device:
            raise ValueError(f"{name} on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b, s, m, d, lq, num_levels, p


def _fwd(value, spatial_shapes, sampling_locations, attention_weights) -> torch.Tensor:
    global LAUNCHES
    b, s, m, d, lq, num_levels, p = _check(
        value, spatial_shapes, sampling_locations, attention_weights)
    if d % 4 or value.data_ptr() % 16:
        raise ValueError(f"K1 takes D % 4 == 0 (got {d}) and a 16-byte aligned value")
    out = torch.empty((b, lq, m * d), dtype=torch.float32, device=value.device)
    lib = _build.library()
    # the launcher plans its staging and grid from the level shapes (host memory)
    rc = lib.s2d_msda_fwd(
        value.data_ptr(), _level_info(spatial_shapes).data_ptr(),
        sampling_locations.data_ptr(), attention_weights.data_ptr(), out.data_ptr(),
        b, s, m, d, lq, num_levels, p, _build.stream_handle(value),
    )
    _build.check(rc, "s2d_msda_fwd")
    LAUNCHES += 1
    return out


def ms_deform_attn_bwd_cuda(
    value: torch.Tensor,  # (B, S, M, D) f32
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # (B, Lq, M, L, P, 2) f32
    attention_weights: torch.Tensor,  # (B, Lq, M, L, P) f32
    grad_out: torch.Tensor,  # (B, Lq, M * D) f32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d value, d locations, d weights) by the K2 kernel, bitwise the same
    from call to call (d value is summed in fixed point); a CPU tensor takes
    `ms_deform_attn_bwd_plain`."""
    global BWD_LAUNCHES
    if not value.is_cuda:
        return ms_deform_attn_bwd_plain(
            value, spatial_shapes, sampling_locations, attention_weights, grad_out)
    spatial_shapes = tuple(map(tuple, spatial_shapes))
    b, s, m, d, lq, num_levels, p = _check(
        value, spatial_shapes, sampling_locations, attention_weights, ("grad_out", grad_out))
    if tuple(grad_out.shape) != (b, lq, m * d):
        raise ValueError(f"grad_out {tuple(grad_out.shape)}")
    if d % 4 or value.data_ptr() % 16 or grad_out.data_ptr() % 16:
        raise ValueError(f"K2 takes D % 4 == 0 (got {d}) and a 16-byte aligned value and grad_out")
    grad_value = torch.empty_like(value)  # every element written by the kernel
    grad_loc = torch.empty_like(sampling_locations)
    grad_attn = torch.empty_like(attention_weights)
    lib = _build.library()
    # the launcher plans its accumulators, staging and grids from the level
    # shapes (host memory)
    rc = lib.s2d_msda_bwd(
        value.data_ptr(), _level_info(spatial_shapes).data_ptr(),
        sampling_locations.data_ptr(), attention_weights.data_ptr(), grad_out.data_ptr(),
        grad_value.data_ptr(), grad_loc.data_ptr(), grad_attn.data_ptr(),
        b, s, m, d, lq, num_levels, p, _build.stream_handle(value),
    )
    _build.check(rc, "s2d_msda_bwd")
    BWD_LAUNCHES += 1
    return grad_value, grad_loc, grad_attn


def ms_deform_attn_bwd_plain(value, spatial_shapes, sampling_locations, attention_weights,
                             grad_out):
    """K2's plain version: autograd through `ms_deform_attn_plain`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_plain(leaves[0], spatial_shapes, leaves[1], leaves[2])
        return torch.autograd.grad(out, leaves, grad_out)


class _MSDAFunction(torch.autograd.Function):
    """Forward K1, backward K2."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return _fwd(value, spatial_shapes, sampling_locations, attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, locs, weights = ctx.saved_tensors
        dv, dl, dw = ms_deform_attn_bwd_cuda(
            value, ctx.spatial_shapes, locs, weights, grad_out.contiguous())
        return dv, dl, dw, None


def ms_deform_attn_cuda(
    value: torch.Tensor,  # (B, S, M, D) f32
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # (B, Lq, M, L, P, 2) f32
    attention_weights: torch.Tensor,  # (B, Lq, M, L, P) f32
) -> torch.Tensor:
    """(B, Lq, M * D) f32, same contract as `ms_deform_attn_plain`, and
    differentiable in value, locations and weights."""
    if not value.is_cuda:
        return ms_deform_attn_plain(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    return _MSDAFunction.apply(
        value, sampling_locations, attention_weights, tuple(map(tuple, spatial_shapes)))
