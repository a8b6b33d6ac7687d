"""Sine positional embeddings (2D image, 3D video), as
`s2d_tpu/models/position_encoding.py`.

The tables are computed in float64 numpy (an all-valid axis's cumsum is
arange(1..N)) and cast once; with `frame_valid` the time phase is computed
in float32 torch, as the JAX version does, so that pad frames do not advance
it and real frames see the same embedding however much the clip was padded.
Layouts are JAX's: (H, W, C) and (T, H, W, C).

JAX computes the all-valid tables once, at trace time, as constants of the
compiled program. The port keeps them on the device per shape (an LRU
cache): recomputing the (T, H, W, C) table in numpy and copying it to the
card on every forward held the device idle for tens of ms a clip. The
cached tensors are shared: callers must not modify them in place.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

_EPS = 1e-6


def _axis_embed(n: int) -> np.ndarray:
    pos = np.arange(1, n + 1, dtype=np.float64)
    return pos / (n + _EPS) * (2 * math.pi)


def _freq(num_feats: int) -> np.ndarray:
    dim_t = np.arange(num_feats, dtype=np.float64)
    return 10000.0 ** (2.0 * (dim_t // 2) / num_feats)


def _interleave_sin_cos(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x)
    out[..., 0::2] = np.sin(x[..., 0::2])
    out[..., 1::2] = np.cos(x[..., 1::2])
    return out


def _sine_2d_np(h: int, w: int, num_pos_feats: int) -> np.ndarray:
    freq = _freq(num_pos_feats)
    pos_y = _interleave_sin_cos(_axis_embed(h)[:, None, None] / freq)
    pos_x = _interleave_sin_cos(_axis_embed(w)[None, :, None] / freq)
    return np.concatenate(
        [np.broadcast_to(pos_y, (h, w, num_pos_feats)),
         np.broadcast_to(pos_x, (h, w, num_pos_feats))],
        axis=-1,
    )


@functools.lru_cache(maxsize=32)
def position_embedding_sine_2d(
    h: int, w: int, num_pos_feats: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """(H, W, 2 * num_pos_feats), channels [y-block | x-block]."""
    return torch.from_numpy(_sine_2d_np(h, w, num_pos_feats)).to(device=device, dtype=dtype)


def position_embedding_sine_3d(
    t: int, h: int, w: int, num_pos_feats: int, dtype=torch.float32, device=None,
    frame_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """(T, H, W, 2 * num_pos_feats): concat(pos_y, pos_x) + pos_z, where pos_z
    spans the whole channel axis. frame_valid: (T,) bool, False = pad frame."""
    if frame_valid is None:
        return _sine_3d_all_valid(t, h, w, num_pos_feats, dtype, device)
    spatial = _sine_2d_np(h, w, num_pos_feats)
    freq_z = _freq(2 * num_pos_feats)
    fv = frame_valid.to(device=device, dtype=torch.float32)
    z = torch.cumsum(fv, 0) / (fv.sum() + _EPS) * (2 * math.pi)
    phase = z[:, None] / torch.from_numpy(freq_z).to(device=device, dtype=torch.float32)
    even = torch.arange(phase.shape[-1], device=device) % 2 == 0
    pos_z = torch.where(even, torch.sin(phase), torch.cos(phase))
    spatial_t = torch.from_numpy(spatial).to(device=device, dtype=torch.float32)
    return (spatial_t[None] + pos_z[:, None, None, :]).to(dtype)


@functools.lru_cache(maxsize=32)
def _sine_3d_all_valid(t, h, w, num_pos_feats, dtype, device) -> torch.Tensor:
    pos_z = _interleave_sin_cos(_axis_embed(t)[:, None] / _freq(2 * num_pos_feats))  # (T, 2F)
    pos = _sine_2d_np(h, w, num_pos_feats)[None] + pos_z[:, None, None, :]
    return torch.from_numpy(pos).to(device=device, dtype=dtype)
