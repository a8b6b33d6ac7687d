"""MSDeformAttn pixel decoder, as `s2d_tpu/models/pixel_decoder.py`.

1x1 conv + GroupNorm(32) input projections of res5/res4/res3 (level 0 =
res5), `enc_layers` deformable encoder layers (the MSDA core: the K1 CUDA
kernel or its plain twin, by `msda_impl`), then the FPN fuse with res2 and
the 1x1 `mask_features` projection. The whole module runs in float32 (the
reference's autocast-off island). Parameter names follow the flax tree.

Training (`deterministic=False`): each encoder layer applies dropout at
`dropout` after its attention, its FFN hidden layer and its FFN output, as
flax's `nn.Dropout` (keep with probability 1 - rate, scale by 1 / (1 -
rate)). The keep masks are drawn from an explicit generator before the
layer runs, so that with `grad_checkpoint` (each encoder layer recomputed in
the backward pass, `torch.utils.checkpoint`) the recomputation replays the
same masks.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.ms_deform_attn import ms_deform_attn
from ..ops.resize import interpolate_bilinear
from .position_encoding import position_embedding_sine_2d


def msda_offset_init_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Directional init of the sampling offsets (deformable-DETR): head h
    points along angle 2*pi*h/H, magnitude growing with the point index."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def encoder_reference_points(
    spatial_shapes: Tuple[Tuple[int, int], ...], device=None
) -> torch.Tensor:
    """(S, L, 2) normalized pixel-centre reference points (all-valid); kept
    on the device per shapes, as JAX keeps it as a trace-time constant."""
    refs = []
    for h, w in spatial_shapes:
        ys = (np.arange(h, dtype=np.float64) + 0.5) / h
        xs = (np.arange(w, dtype=np.float64) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        refs.append(np.stack([gx.ravel(), gy.ravel()], axis=-1))
    pts = np.concatenate(refs, axis=0).astype(np.float32)
    pts = np.broadcast_to(pts[:, None, :], (pts.shape[0], len(spatial_shapes), 2))
    return torch.from_numpy(np.ascontiguousarray(pts)).to(device)


@functools.lru_cache(maxsize=16)
def _normalizer(spatial_shapes, dtype, device) -> torch.Tensor:
    """(L, 2) [W, H] per level, on the device."""
    return torch.tensor([[w, h] for h, w in spatial_shapes], dtype=dtype, device=device)


class MSDeformAttnModule(nn.Module):
    """Projections around the deformable-attention core."""

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4, impl: str = "plain"):
        super().__init__()
        self.n_heads, self.n_levels, self.n_points, self.impl = n_heads, n_levels, n_points, impl
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, reference_points, value_src, spatial_shapes):
        b, s, c = query.shape
        m, l, p = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_src).view(b, s, m, c // m)
        offsets = self.sampling_offsets(query).view(b, s, m, l, p, 2)
        attn = self.attention_weights(query).view(b, s, m, l * p)
        attn = torch.softmax(attn, dim=-1).view(b, s, m, l, p)
        normalizer = _normalizer(tuple(spatial_shapes), offsets.dtype, offsets.device)
        locations = (
            reference_points[None, :, None, :, None, :]
            + offsets / normalizer[None, None, None, :, None, :]
        )
        out = ms_deform_attn(value, spatial_shapes, locations, attn, impl=self.impl)
        return self.output_proj(out)


class MSDeformAttnEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, d_ffn: int = 1024, n_levels: int = 3,
                 n_heads: int = 8, n_points: int = 4, impl: str = "plain"):
        super().__init__()
        self.self_attn = MSDeformAttnModule(d_model, n_levels, n_heads, n_points, impl)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def draw_dropout(self, src: torch.Tensor, rate: float,
                     generator: torch.Generator | None) -> Tuple[torch.Tensor, ...]:
        """Keep masks of the three dropouts, with probability 1 - rate."""
        shapes = (src.shape, (*src.shape[:-1], self.linear1.out_features), src.shape)
        return tuple(
            torch.rand(shape, generator=generator, device=src.device) < 1.0 - rate
            for shape in shapes
        )

    def forward(self, src, pos, reference_points, spatial_shapes, keep=None, rate=0.0):
        """`keep`: the three dropout keep masks, or None (no dropout)."""

        def drop(x, i):
            if keep is None:
                return x
            return torch.where(keep[i], x / (1.0 - rate), x.new_zeros(()))

        attn_out = self.self_attn(src + pos, reference_points, src, spatial_shapes)
        src = self.norm1(src + drop(attn_out, 0))
        ffn = self.linear2(drop(F.relu(self.linear1(src)), 1))
        return self.norm2(src + drop(ffn, 2))


class MSDeformAttnPixelDecoder(nn.Module):
    """NCHW features -> (mask_features NCHW, [res5', res4', res3'] as
    channels-last (N, h, w, C) maps, the order the video decoder cycles)."""

    transformer_in_features = ("res3", "res4", "res5")

    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 256,
                 mask_dim: int = 256, enc_layers: int = 6, nheads: int = 8,
                 dim_feedforward: int = 1024, n_points: int = 4,
                 msda_impl: str = "plain", dropout: float = 0.0,
                 grad_checkpoint: bool = False):
        super().__init__()
        self.conv_dim = conv_dim
        self.dropout, self.grad_checkpoint = dropout, grad_checkpoint
        self.names_td = sorted(self.transformer_in_features, reverse=True)
        for idx, name in enumerate(self.names_td):
            self.add_module(f"input_proj{idx}_conv", nn.Conv2d(in_channels[name], conv_dim, 1))
            self.add_module(f"input_proj{idx}_gn", nn.GroupNorm(32, conv_dim, eps=1e-5))
        self.level_embed = nn.Parameter(torch.zeros(len(self.names_td), conv_dim))
        self.encoder_layers = []
        for i in range(enc_layers):
            layer = MSDeformAttnEncoderLayer(
                conv_dim, dim_feedforward, len(self.names_td), nheads, n_points, msda_impl
            )
            self.add_module(f"encoder_layer{i}", layer)
            self.encoder_layers.append(layer)
        self.adapter1_conv = nn.Conv2d(in_channels["res2"], conv_dim, 1, bias=False)
        self.adapter1_gn = nn.GroupNorm(32, conv_dim, eps=1e-5)
        self.layer1_conv = nn.Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False)
        self.layer1_gn = nn.GroupNorm(32, conv_dim, eps=1e-5)
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, 1)

    def forward(self, features: Dict[str, torch.Tensor], deterministic: bool = True,
                generator: torch.Generator | None = None,
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        srcs, pos_embeds, spatial_shapes = [], [], []
        for idx, name in enumerate(self.names_td):
            x = features[name].float()
            n, _, h, w = x.shape
            proj = getattr(self, f"input_proj{idx}_gn")(getattr(self, f"input_proj{idx}_conv")(x))
            srcs.append(proj.permute(0, 2, 3, 1).reshape(n, h * w, self.conv_dim))
            pe = position_embedding_sine_2d(h, w, self.conv_dim // 2, device=x.device)
            pos_embeds.append(pe.reshape(1, h * w, -1) + self.level_embed[idx][None, None, :])
            spatial_shapes.append((h, w))
        src_flat = torch.cat(srcs, dim=1)
        pos_flat = torch.cat(pos_embeds, dim=1).expand(src_flat.shape[0], -1, -1)
        ref_points = encoder_reference_points(tuple(spatial_shapes), device=src_flat.device)

        out_seq = src_flat
        for layer in self.encoder_layers:
            keep = None
            if not deterministic and self.dropout > 0.0:
                keep = layer.draw_dropout(out_seq, self.dropout, generator)
            args = (out_seq, pos_flat, ref_points, spatial_shapes, keep, self.dropout)
            if self.grad_checkpoint and torch.is_grad_enabled():
                out_seq = checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                out_seq = layer(*args)

        outs, start = [], 0
        for h, w in spatial_shapes:
            outs.append(out_seq[:, start : start + h * w].reshape(-1, h, w, self.conv_dim))
            start += h * w

        x2 = features["res2"].float()
        lateral = self.adapter1_gn(self.adapter1_conv(x2))
        up = interpolate_bilinear(outs[-1].permute(0, 3, 1, 2), tuple(x2.shape[2:]))
        fused = F.relu(self.layer1_gn(self.layer1_conv(lateral + up)))
        return self.mask_features(fused), outs
