"""ResNet backbone with FrozenBN, as `s2d_tpu/models/resnet.py`.

d2's `build_resnet_backbone` for the reference configs: 7x7/2 stem conv +
FrozenBN + relu + 3x3/2 max pool, then bottleneck stacks (3, 4, 6, 3) with
the stride on the 3x3 conv (STRIDE_IN_1X1=False). FrozenBN is the folded
affine y = x * weight + bias. NCHW inside; parameter names follow the flax
tree (`stem_conv1`, `res2_block0.conv1`, ...).

FrozenBN's weight and bias are parameters, as the JAX package's flax
params: they receive gradients, which count in the train step's global-norm
clip, and the optimizer gives them a learning rate of 0. (Detectron2 keeps
them as buffers, outside the norm.)
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

BOTTLENECK_STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
RESNET_FEATURE_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


class FrozenBN(nn.Module):
    """y = x * weight + bias per channel; the optimizer never moves them."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight[:, None, None] + self.bias[:, None, None]


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, padding=(kernel - 1) // 2, bias=False)


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 stride: int = 1, has_shortcut: bool = False):
        super().__init__()
        if has_shortcut:
            self.shortcut = _conv(in_channels, out_channels, 1, stride)
            self.shortcut_norm = FrozenBN(out_channels)
        else:
            self.shortcut = None
        self.conv1 = _conv(in_channels, bottleneck_channels, 1)
        self.norm1 = FrozenBN(bottleneck_channels)
        self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3, stride)
        self.norm2 = FrozenBN(bottleneck_channels)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1)
        self.norm3 = FrozenBN(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.shortcut is not None:
            shortcut = self.shortcut_norm(self.shortcut(x))
        out = F.relu(self.norm1(self.conv1(x)))
        out = F.relu(self.norm2(self.conv2(out)))
        out = self.norm3(self.conv3(out))
        return F.relu(out + shortcut)


class ResNet(nn.Module):
    """NCHW images -> {"res2": ..., "res5": ...} NCHW feature maps."""

    def __init__(self, depth: int = 50, stem_out_channels: int = 64,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stem_conv1 = _conv(3, stem_out_channels, 7, 2)
        self.stem_norm1 = FrozenBN(stem_out_channels)
        self.stages = []
        in_channels, out_channels, bottleneck = stem_out_channels, 256, 64
        for stage_idx, num_blocks in enumerate(BOTTLENECK_STAGES[depth]):
            name = f"res{stage_idx + 2}"
            stride = 1 if stage_idx == 0 else 2
            blocks = []
            for block_idx in range(num_blocks):
                block = BottleneckBlock(
                    in_channels if block_idx == 0 else out_channels,
                    out_channels, bottleneck,
                    stride=stride if block_idx == 0 else 1,
                    has_shortcut=block_idx == 0,
                )
                self.add_module(f"{name}_block{block_idx}", block)
                blocks.append(block)
            self.stages.append((name, blocks))
            in_channels = out_channels
            out_channels *= 2
            bottleneck *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = F.relu(self.stem_norm1(self.stem_conv1(x)))
        out = F.max_pool2d(out, kernel_size=3, stride=2, padding=1)
        features = {}
        for name, blocks in self.stages:
            for block in blocks:
                out = block(out)
            if name in self.out_features:
                features[name] = out
        return features
