"""FlashOcc-style channel-to-height occupancy head: counterpart of
``dhd_tpu/nn/occ_head.py`` (``predictor``, dense_heads/occ_head.py:33-100).

3x3 conv + ReLU, a (Dy, Dx) -> (Dx, Dy) transpose, then an MLP
(Linear -> Softplus -> Linear) over the channels.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .fpn import _ConvHolder
from .layers import Linear


class OccHead(nn.Module):
    """forward(x (B, C, Dy, Dx)) -> (B, Dx, Dy, Dz*n_cls) when
    ``return_flat`` (the packed layout, z-major over classes), else
    (B, Dx, Dy, Dz, n_cls)."""

    def __init__(self, in_dim: int = 256, out_dim: int = 256, Dz: int = 16,
                 num_classes: int = 18, use_predicter: bool = True,
                 return_flat: bool = False):
        super().__init__()
        self.Dz = Dz
        self.num_classes = num_classes
        self.use_predicter = use_predicter
        self.return_flat = return_flat
        out_ch = out_dim if use_predicter else Dz * num_classes
        self.final_conv = _ConvHolder(in_dim, out_ch, 3, padding=1)
        if use_predicter:
            self.predicter = nn.Sequential(
                Linear(out_dim, out_dim * 2), nn.Softplus(),
                Linear(out_dim * 2, Dz * num_classes))

    def forward(self, x) -> torch.Tensor:
        # mmcv ConvModule's default act is ReLU (occ_head.py:52-60); then
        # (B, C, Dy, Dx) -> (B, Dx, Dy, C) (occ_head.py:93)
        x = F.relu(self.final_conv(x)).permute(0, 3, 2, 1)
        if self.use_predicter:
            x = self.predicter(x)
        if self.return_flat:
            return x
        b, dx, dy = x.shape[:3]
        return x.reshape(b, dx, dy, self.Dz, self.num_classes)
