"""UNet voxel-slab encoder (models/backbones/unet.py:7-143): counterpart of
``dhd_tpu/nn/unet.py`` in NCHW.

Encoder base..16*base via maxpool + DoubleConv, decoder via ConvTranspose2d
(k2 s2) + skip concat + DoubleConv, 1x1 out conv.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, Conv2d, ConvTranspose2d


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            Conv2d(cin, cout, 3, padding=1, bias=False),
            BatchNorm2d(cout), nn.ReLU(inplace=True),
            Conv2d(cout, cout, 3, padding=1, bias=False),
            BatchNorm2d(cout), nn.ReLU(inplace=True))

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    """2x2 max pool, stride 2, then DoubleConv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConv(cin, cout))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    """ConvTranspose (k2, s2) halving the channels, pad to the skip's size
    (the odd-size guard, unet.py:95-99), skip-concat, DoubleConv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = ConvTranspose2d(cin, cin // 2, 2, 2)
        self.conv = DoubleConv(cin, cout)

    def forward(self, x1, x2):
        x1 = self.up(x1)
        dy = x2.shape[2] - x1.shape[2]
        dx = x2.shape[3] - x1.shape[3]
        if dy or dx:
            x1 = F.pad(x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        return self.conv(torch.cat([x2, x1], dim=1))


class _OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    """UNet(n_channels -> n_classes) with the channel ladder base..16*base
    (the reference hardcodes base=64)."""

    def __init__(self, n_channels: int, n_classes: int, base: int = 64):
        super().__init__()
        b = base
        self.inc = DoubleConv(n_channels, b)
        self.down1 = Down(b, b * 2)
        self.down2 = Down(b * 2, b * 4)
        self.down3 = Down(b * 4, b * 8)
        self.down4 = Down(b * 8, b * 16)
        self.up1 = Up(b * 16, b * 8)
        self.up2 = Up(b * 8, b * 4)
        self.up3 = Up(b * 4, b * 2)
        self.up4 = Up(b * 2, b)
        self.outc = _OutConv(b, n_classes)

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x = self.up1(self.down4(x4), x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        return self.outc(self.up4(x, x1))
