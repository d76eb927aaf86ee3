"""SFA — Synergistic Feature Aggregation (models/necks/mix.py:8-90):
counterpart of ``dhd_tpu/nn/sfa.py`` in NCHW.

A channel-attention stage (global pool -> FC bottleneck -> sigmoid alpha;
fuse a*bev + (1-a)*voxel), a spatial-attention stage (1x1 conv gate, same
mixing), then a residual block over the fused half plus a 1x1 shortcut over
the full concat.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, Conv2d, Linear


class ChannelSpatialStage(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        c = channels // 2
        self.fc = nn.Sequential(
            Linear(channels, channels // reduction), nn.ReLU(),
            Linear(channels // reduction, c))
        self.spacial_leanring = nn.Sequential(       # (sic) reference name
            Conv2d(c, c, 1), BatchNorm2d(c), nn.ReLU(),
            Conv2d(c, c, 1), BatchNorm2d(c))

    def forward(self, x):
        c = x.shape[1] // 2
        x_bev, x_vox = x[:, :c], x[:, c:]
        a = torch.sigmoid(self.fc(x.mean(dim=(2, 3))))[:, :, None, None]
        x_bev1 = a * x_bev
        x_vox1 = (1 - a) * x_vox
        g = torch.sigmoid(self.spacial_leanring(x_bev1 + x_vox1))
        return g * x_bev1 + (1 - g) * x_vox1


class SFA(nn.Module):
    def __init__(self, in_channels: int = 512, out_channels: int = 256):
        super().__init__()
        c = in_channels // 2
        self.mysk_7 = ChannelSpatialStage(in_channels)
        self.mix_residual = nn.Sequential(
            Conv2d(c, out_channels, 3, padding=1, bias=False),
            BatchNorm2d(out_channels), nn.ReLU(),
            Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            BatchNorm2d(out_channels))
        self.mix_shortcut = nn.Sequential(
            Conv2d(in_channels, out_channels, 1, bias=False),
            BatchNorm2d(out_channels))

    def forward(self, x):
        return F.relu(self.mix_residual(self.mysk_7(x))
                      + self.mix_shortcut(x))
