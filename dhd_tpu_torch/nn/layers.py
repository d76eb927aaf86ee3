"""Shared NN building blocks (NCHW), counterparts of ``dhd_tpu/nn/layers.py``.

Attribute names follow the reference's state_dict key space (the naming
template ``dhd_tpu/oracle/torch_ref.py`` uses), so a reference ``.pth`` or a
converted JAX checkpoint loads with ``strict=True``.  BatchNorm is torch's
own (eps 1e-5, momentum 0.1); the port serves in eval mode on running
statistics.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvBNReLU(nn.Module):
    """conv -> BN -> ReLU.  The attribute names are those of the
    reference's ``_ASPPModule`` (depthnet.py:10-40), its one user."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 dilation: int = 1):
        super().__init__()
        pad = dilation * (kernel - 1) // 2
        self.atrous_conv = nn.Conv2d(cin, cout, kernel, padding=pad,
                                     dilation=dilation, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.atrous_conv(x)))


class BasicBlock(nn.Module):
    """mmdet BasicBlock: 3x3(s)-BN-ReLU-3x3-BN + skip, ReLU.  ``downsample``
    is None (identity) or the skip-branch module: a bare 3x3 conv in
    CustomResNet (models/backbones/resnet.py:47-48), a 1x1 conv in the
    stereo DepthNet."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = downsample

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + idt)


def conv_basic_block(cin: int, cout: int, stride: int) -> BasicBlock:
    """BasicBlock whose skip branch is a bare 3x3 conv with bias."""
    return BasicBlock(cin, cout, stride,
                      downsample=nn.Conv2d(cin, cout, 3, stride, 1))


def conv1x1_basic_block(cin: int, cout: int) -> BasicBlock:
    """BasicBlock whose skip branch is a 1x1 conv with bias (the stereo
    DepthNet's first block, depthnet.py:204-206)."""
    return BasicBlock(cin, cout, downsample=nn.Conv2d(cin, cout, 1))


class Bottleneck(nn.Module):
    """torchvision/mmdet Bottleneck ('pytorch' style: stride on the 3x3)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, expansion: int = 4):
        super().__init__()
        cout = planes * expansion
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + idt)


class Mlp(nn.Module):
    """2-layer MLP with ReLU (depthnet.py:119-147)."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.fc1 = nn.Linear(cin, hidden)
        self.fc2 = nn.Linear(hidden, cout)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class SELayer(nn.Module):
    """Camera-aware SE gate (depthnet.py:150-169): x * sigmoid(MLP(se)),
    with the MLP as 1x1 convs over a (B, C, 1, 1) embedding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, channels, 1)
        self.conv_expand = nn.Conv2d(channels, channels, 1)

    def forward(self, x, x_se):
        g = self.conv_expand(F.relu(self.conv_reduce(x_se)))
        return x * torch.sigmoid(g)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (depthnet.py:42-116): 1x1 and 3x3
    d6/d12/d18 branches plus a global-average branch, concat -> 1x1 conv ->
    BN -> ReLU (-> dropout, an identity in eval)."""

    def __init__(self, cin: int, mid: int, dropout: float = 0.5):
        super().__init__()
        self.aspp1 = ConvBNReLU(cin, mid, 1)
        self.aspp2 = ConvBNReLU(cin, mid, 3, dilation=6)
        self.aspp3 = ConvBNReLU(cin, mid, 3, dilation=12)
        self.aspp4 = ConvBNReLU(cin, mid, 3, dilation=18)
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d((1, 1)),
            nn.Conv2d(cin, mid, 1, bias=False),
            nn.BatchNorm2d(mid), nn.ReLU())
        self.conv1 = nn.Conv2d(mid * 5, cin, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cin)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        b4 = self.aspp4(x)
        g = self.global_avg_pool(x).expand(-1, -1, *b4.shape[2:])
        y = torch.cat([self.aspp1(x), self.aspp2(x), self.aspp3(x), b4, g],
                      dim=1)
        return self.dropout(F.relu(self.bn1(self.conv1(y))))


def upsample_bilinear_align(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear x``scale`` upsample with align_corners=True: output pixel i
    samples the input at i*(in-1)/(out-1).  x: (B, C, H, W)."""
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(h * scale, w * scale), mode="bilinear",
                         align_corners=True)
