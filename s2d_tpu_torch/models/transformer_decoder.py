"""Video multi-scale masked transformer decoder, as
`s2d_tpu/models/transformer_decoder.py`.

Learnable queries shared across frames; `dec_layers` rounds of masked
cross-attention over one feature level (cycling res5 -> res3) -> self-
attention -> FFN; prediction heads after the initial queries and after
every round (aux outputs). The next round's cross-attention mask is
sigmoid(mask logits resized to the level) < 0.5, with fully blocked query
rows unmasked over the real keys; keys of pad frames (`frame_valid` False)
stay blocked.

`compute_dtype` reproduces the JAX cast points of the AMP eval path: the
3D position embedding and the initial queries are rounded to it, and the
first round's `output + qpos` is a sum of two rounded values rounded again.
Everything else computes in float32, as flax promotes a bf16 activation
meeting f32 parameters to f32.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import interpolate_bilinear
from .attention import MultiheadAttention
from .position_encoding import position_embedding_sine_3d


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype`, held in float32 (identity for float32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


class FFN(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x):
        return self.norm(x + self.linear2(F.relu(self.linear1(x))))


class MaskEmbedMLP(nn.Module):
    def __init__(self, hidden_dim: int, mask_dim: int):
        super().__init__()
        self.layer0 = nn.Linear(hidden_dim, hidden_dim)
        self.layer1 = nn.Linear(hidden_dim, hidden_dim)
        self.layer2 = nn.Linear(hidden_dim, mask_dim)

    def forward(self, x):
        x = F.relu(self.layer0(x))
        x = F.relu(self.layer1(x))
        return self.layer2(x)


class VideoMaskedTransformerDecoder(nn.Module):
    def __init__(self, num_classes: int = 1, hidden_dim: int = 256, num_queries: int = 100,
                 nheads: int = 8, dim_feedforward: int = 2048, dec_layers: int = 9,
                 mask_dim: int = 256, num_feature_levels: int = 3,
                 flash_cross_attention: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_queries, self.hidden_dim = num_queries, hidden_dim
        self.dec_layers, self.num_feature_levels = dec_layers, num_feature_levels
        self.compute_dtype = compute_dtype
        self.query_feat = nn.Parameter(torch.zeros(num_queries, hidden_dim))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, hidden_dim))
        self.level_embed = nn.Parameter(torch.zeros(num_feature_levels, hidden_dim))
        self.decoder_norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MaskEmbedMLP(hidden_dim, mask_dim)
        self.layers = []
        for i in range(dec_layers):
            mods = {
                "cross_attn": MultiheadAttention(hidden_dim, nheads, use_flash=flash_cross_attention),
                "cross_norm": nn.LayerNorm(hidden_dim, eps=1e-5),
                "self_attn": MultiheadAttention(hidden_dim, nheads),
                "self_norm": nn.LayerNorm(hidden_dim, eps=1e-5),
                "ffn": FFN(hidden_dim, dim_feedforward),
            }
            for name, mod in mods.items():
                self.add_module(f"layer{i}_{name}", mod)
            self.layers.append(mods)

    def attention_mask(self, out_mask: torch.Tensor, attn_size,
                       frame_valid: torch.Tensor | None = None) -> torch.Tensor:
        """(B, Q, T*h*w) bool, True = blocked: mask logits resized to the
        level, sigmoid < 0.5, fully blocked rows unmasked over the real keys.
        A hard threshold: two f32 paths whose logits differ by rounding can
        decide a key near 0 differently."""
        b, q = out_mask.shape[:2]
        small = interpolate_bilinear(out_mask, attn_size)
        blocked = torch.sigmoid(small).reshape(b, q, -1) < 0.5
        if frame_valid is None:
            return blocked & ~blocked.all(dim=-1, keepdim=True)
        hl, wl = attn_size
        pad = (~frame_valid.to(out_mask.device)).repeat_interleave(hl * wl)[None, None, :]
        blocked = blocked | pad
        # a fully blocked row attends everywhere REAL: pad keys stay blocked
        return (blocked & ~blocked.all(dim=-1, keepdim=True)) | pad

    def forward(
        self,
        x: Sequence[torch.Tensor],  # per level (B, T, h, w, C), res5 -> res3
        mask_features: torch.Tensor,  # (B, T, C, H, W), stride 4
        frame_valid: torch.Tensor | None = None,  # (T,) bool; False = pad frame
    ) -> Dict[str, torch.Tensor]:
        assert len(x) == self.num_feature_levels
        b, t = x[0].shape[0], x[0].shape[1]
        q, c = self.num_queries, self.hidden_dim
        dt = self.compute_dtype
        device = mask_features.device

        srcs, poses, sizes = [], [], []
        for i, feat in enumerate(x):
            h, w = feat.shape[2], feat.shape[3]
            sizes.append((h, w))
            srcs.append(feat.reshape(b, t * h * w, c) + self.level_embed[i][None, None, :])
            pe = position_embedding_sine_3d(
                t, h, w, c // 2, dtype=dt, device=device, frame_valid=frame_valid
            ).float()
            poses.append(pe.reshape(1, t * h * w, c))

        def prediction_heads(output, attn_size):
            normed = self.decoder_norm(output)
            out_cls = self.class_embed(normed)
            membed = self.mask_embed(normed)
            out_mask = torch.einsum("bqc,btchw->bqthw", membed, mask_features)
            return out_cls, out_mask, self.attention_mask(out_mask, attn_size, frame_valid)

        output = round_to(self.query_feat, dt)[None].expand(b, q, c)
        qpos = round_to(self.query_embed, dt)[None].expand(b, q, c)

        pred_logits: List[torch.Tensor] = []
        pred_masks: List[torch.Tensor] = []
        out_cls, out_mask, attn_mask = prediction_heads(output, sizes[0])
        pred_logits.append(out_cls)
        pred_masks.append(out_mask)

        for i, mods in enumerate(self.layers):
            li = i % self.num_feature_levels
            # in round 0 `output` still holds the rounded queries: their sum
            # with qpos is a low-precision add in JAX
            query = round_to(output + qpos, dt) if i == 0 else output + qpos
            ca = mods["cross_attn"](
                query, srcs[li] + poses[li], srcs[li], attn_mask=attn_mask[:, None]
            )
            output = mods["cross_norm"](output + ca)
            sa = mods["self_attn"](output + qpos, output + qpos, output)
            output = mods["self_norm"](output + sa)
            output = mods["ffn"](output)
            out_cls, out_mask, attn_mask = prediction_heads(
                output, sizes[(i + 1) % self.num_feature_levels]
            )
            pred_logits.append(out_cls)
            pred_masks.append(out_mask)

        return {
            "pred_logits": pred_logits[-1],
            "pred_masks": pred_masks[-1],
            "aux_pred_logits": pred_logits[:-1],
            "aux_pred_masks": pred_masks[:-1],
        }
