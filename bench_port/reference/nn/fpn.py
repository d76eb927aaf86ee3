"""Image neck (CustomFPN) and BEV-encoder neck (FPN_LSS): counterparts of
``dhd_tpu/nn/fpn.py`` (models/necks/fpn.py:11-203, lss_fpn.py:12-75)."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, Conv2d, upsample_bilinear_align


class _ConvHolder(nn.Module):
    """mmcv ConvModule without norm or activation: the conv sits at
    ``.conv``, as in the reference's keys."""

    def __init__(self, cin: int, cout: int, k: int, **kw):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, **kw)

    def forward(self, x):
        return self.conv(x)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of (B, C, H, W) to ``size`` with half-pixel centres,
    as ``jax.image.resize(..., "nearest")``: output i reads input
    floor((i + 0.5) * in / out).  That is torch's "nearest-exact";
    ``mode="nearest"`` reads floor(i * in / out) and agrees only for integer
    scales (DHD-S's 2x), not for dhd_tiny's 6 -> 11 columns."""
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


class CustomFPN(nn.Module):
    """FPN that returns only its finest level (DHD-S: in [1024, 2048] -> 256,
    num_outs=1, out_ids=[0]): 1x1 laterals, top-down nearest upsample + add,
    one 3x3 output conv."""

    def __init__(self, in_channels: Sequence[int] = (1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            [_ConvHolder(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [_ConvHolder(out_channels, out_channels, 3, padding=1)])

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        lat = [m(f) for m, f in zip(self.lateral_convs, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + resize_nearest(lat[i],
                                                     lat[i - 1].shape[2:])
        return self.fpn_convs[0](lat[0])


class FPN_LSS(nn.Module):
    """2-level fuse neck: upsample the deep level (bilinear, align_corners),
    concat with the shallow level, 2x conv-BN-ReLU, then an optional x2
    upsample head ending in a 1x1 conv.  Sequential indices follow the
    reference (conv.{0,1,3,4}, up2.{1,2,4})."""

    def __init__(self, in_channels: int, out_channels: int,
                 scale_factor: int = 4,
                 input_feature_index: Tuple[int, int] = (0, 2),
                 extra_upsample: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.input_feature_index = input_feature_index
        self.extra_upsample = extra_upsample
        mid = out_channels * (2 if extra_upsample else 1)
        self.conv = nn.Sequential(
            Conv2d(in_channels, mid, 3, padding=1, bias=False),
            BatchNorm2d(mid), nn.ReLU(inplace=True),
            Conv2d(mid, mid, 3, padding=1, bias=False),
            BatchNorm2d(mid), nn.ReLU(inplace=True))
        if extra_upsample:
            self.up2 = nn.Sequential(
                nn.Identity(),          # the reference's nn.Upsample slot
                Conv2d(mid, out_channels, 3, padding=1, bias=False),
                BatchNorm2d(out_channels), nn.ReLU(inplace=True),
                Conv2d(out_channels, out_channels, 1))

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x2 = feats[self.input_feature_index[0]]
        x1 = upsample_bilinear_align(feats[self.input_feature_index[1]],
                                     self.scale_factor)
        x = self.conv(torch.cat([x2, x1], dim=1))
        if self.extra_upsample:
            x = self.up2(upsample_bilinear_align(x, self.extra_upsample))
        return x
