"""Video MaskFormer: backbone -> pixel decoder -> video decoder, as
`s2d_tpu/models/meta_arch.py`.

Input convention (JAX's): images normalized and padded to the size
divisibility, (B, T, H, W, 3) channels-last. Outputs: pred_logits
(B, Q, K+1), pred_masks (B, Q, T, H/4, W/4) and the aux lists.

Dtypes (the JAX AMP eval path, reproduced): with compute_dtype=bf16 the
JAX model casts only activations -- the input frames, the pixel decoder's
outputs, and inside the decoder the queries and the position embedding --
and flax promotes each bf16 activation meeting an f32 parameter to f32. So
the JAX "bf16" eval path computes in f32 between those points; the port
rounds at exactly those points (`round_to`) and computes in f32.

Train mode (`model.train()`, `build_model(..., train=True)`) is JAX's
`deterministic=False`: the pixel decoder's encoder dropout is on, drawn from
the generator given to `forward`. `grad_checkpoint` recomputes each encoder
layer in the backward pass. The flash cross-attention (K3) stays an eval
path, as in JAX.
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from ..config import VideoConfig
from .attention import MultiheadAttention
from .pixel_decoder import MSDeformAttnModule, MSDeformAttnPixelDecoder, msda_offset_init_bias
from .resnet import RESNET_FEATURE_CHANNELS, FrozenBN, ResNet
from .transformer_decoder import VideoMaskedTransformerDecoder, round_to


class VideoMaskFormer(nn.Module):
    def __init__(self, num_classes: int = 1, hidden_dim: int = 256, mask_dim: int = 256,
                 num_queries: int = 100, nheads: int = 8, dim_feedforward: int = 2048,
                 dec_layers: int = 10, transformer_enc_layers: int = 6,
                 enc_dim_feedforward: int = 1024, enc_n_points: int = 4,
                 backbone_depth: int = 50, msda_impl: str = "plain",
                 flash_cross_attention: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 enc_dropout: float = 0.0, grad_checkpoint: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.backbone = ResNet(depth=backbone_depth)
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            RESNET_FEATURE_CHANNELS, conv_dim=hidden_dim, mask_dim=mask_dim,
            enc_layers=transformer_enc_layers, nheads=nheads,
            dim_feedforward=enc_dim_feedforward, n_points=enc_n_points,
            msda_impl=msda_impl, dropout=enc_dropout, grad_checkpoint=grad_checkpoint,
        )
        # dec_layers is the config value; the decoder runs dec_layers - 1 rounds
        self.predictor = VideoMaskedTransformerDecoder(
            num_classes=num_classes, hidden_dim=hidden_dim, num_queries=num_queries,
            nheads=nheads, dim_feedforward=dim_feedforward, dec_layers=dec_layers - 1,
            mask_dim=mask_dim, flash_cross_attention=flash_cross_attention,
            compute_dtype=compute_dtype,
        )

    def forward(self, images: torch.Tensor, frame_valid: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> Dict[str, torch.Tensor]:
        """`generator` draws the encoder dropout in train mode."""
        b, t, h, w, _ = images.shape
        dt = self.compute_dtype
        frames = round_to(images.reshape(b * t, h, w, 3).float(), dt)
        with record_function("backbone"):
            features = self.backbone(frames.permute(0, 3, 1, 2).contiguous())
        with record_function("pixel_decoder"):
            mask_features, ms_feats = self.pixel_decoder(
                features, deterministic=not self.training, generator=generator)
        # the f32 pixel-decoder island ends here
        ms_video = [round_to(f, dt).reshape(b, t, *f.shape[1:]) for f in ms_feats]
        mask_features = round_to(mask_features, dt)
        mask_features = mask_features.reshape(b, t, *mask_features.shape[1:])
        with record_function("decoder"):
            return self.predictor(ms_video, mask_features, frame_valid=frame_valid)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with flax's defaults: lecun-normal (truncated)
    Dense/Conv kernels and zero biases, unit norms, N(0, 1) embeddings,
    xavier-uniform attention projections, and the MSDA layers' zero kernels
    with the directional offset bias."""

    def lecun_(weight: torch.Tensor) -> None:
        fan_in = weight[0].numel()
        # flax truncates at 2 std and rescales the std to keep the variance
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                lecun_(mod.weight)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, FrozenBN)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, MultiheadAttention):
                nn.init.xavier_uniform_(mod.in_proj_weight, generator=generator)
                nn.init.xavier_uniform_(mod.out_proj_weight, generator=generator)
                mod.in_proj_bias.zero_()
                mod.out_proj_bias.zero_()
        # after the generic pass, which visits these modules' Linears last
        for mod in model.modules():
            if isinstance(mod, MSDeformAttnModule):
                mod.sampling_offsets.weight.zero_()
                mod.sampling_offsets.bias.copy_(torch.from_numpy(msda_offset_init_bias(
                    mod.n_heads, mod.n_levels, mod.n_points)))
                mod.attention_weights.weight.zero_()
        for pname, param in model.named_parameters():
            if pname.endswith(("level_embed", "query_feat", "query_embed")):
                param.normal_(0.0, 1.0, generator=generator)


def build_model(
    cfg: VideoConfig,
    msda_impl: str = "plain",
    flash_cross_attention: bool = False,
    seed: int | None = 0,
    device=None,
    train: bool = False,
    enc_dropout: float = 0.0,
    grad_checkpoint: bool = False,
) -> VideoMaskFormer:
    """The configured model on `device`, initialised from `seed` (None: leave
    the parameters for a state_dict load), in train or eval mode.
    msda_impl: "plain" | "cuda". With cfg.amp the activations round to bf16
    at the JAX cast points."""
    model = VideoMaskFormer(
        num_classes=cfg.num_classes, hidden_dim=cfg.hidden_dim, mask_dim=cfg.mask_dim,
        num_queries=cfg.num_queries, nheads=cfg.nheads,
        dim_feedforward=cfg.dim_feedforward, dec_layers=cfg.dec_layers,
        transformer_enc_layers=cfg.enc_layers, enc_dim_feedforward=cfg.enc_dim_feedforward,
        enc_n_points=cfg.enc_n_points, backbone_depth=cfg.backbone_depth,
        msda_impl=msda_impl, flash_cross_attention=flash_cross_attention,
        compute_dtype=torch.bfloat16 if cfg.amp else torch.float32,
        enc_dropout=enc_dropout, grad_checkpoint=grad_checkpoint,
    )
    if seed is not None:
        init_parameters(model, torch.Generator().manual_seed(seed))
    return model.train(train).to(device)


@functools.lru_cache(maxsize=8)
def _channels(values, device) -> torch.Tensor:
    """Per-channel constants kept on the device (no copy to it per clip)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def preprocess_clip(
    frames,  # (T, H, W, 3) uint8 or float RGB, numpy or torch
    pixel_mean: Sequence[float],
    pixel_std: Sequence[float],
    size_divisibility: int = 32,
    device=None,
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Normalize and zero-pad H, W up to the divisibility. The frames move
    to the device in their own dtype (uint8: 4x less upload than f32) and
    are normalized there. Returns (1, T, H_pad, W_pad, 3) f32 and (H, W)."""
    x = torch.as_tensor(np.asarray(frames) if not torch.is_tensor(frames) else frames)
    x = x.to(device)
    t, h, w, _ = x.shape
    x = (x.float() - _channels(tuple(pixel_mean), x.device)) / _channels(tuple(pixel_std), x.device)
    pad_h, pad_w = -h % size_divisibility, -w % size_divisibility
    if pad_h or pad_w:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    return x[None], (h, w)
