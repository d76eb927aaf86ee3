"""HeightNet with its deformable conv: counterpart of the DHD-S parts of
``dhd_tpu/nn/depthnet.py`` (model_utils/depthnet.py:172-652).

A reduce conv, an SE gate driven by the 27-dim camera embedding, 3
BasicBlocks + ASPP (+ deformable conv) + a 1x1 projection to the height
bins.  The deformable conv is mmcv's DCN v1 as configured in
depthnet.py:226-236 (deform_groups=1, conv groups=4, zero-init offsets),
written as plain-torch bilinear sampling.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from dhd_tpu_torch.config import DepthNetConfig
from .layers import ASPP, BasicBlock, Mlp, SELayer

_KY = (-1., -1., -1., 0., 0., 0., 1., 1., 1.)
_KX = (-1., 0., 1., -1., 0., 1., -1., 0., 1.)


def bilinear_sample_abs(img: torch.Tensor, py: torch.Tensor,
                        px: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at absolute pixel coords, zero outside the image
    (the contract of ``dhd_tpu/nn/depthnet.py:_bilinear_sample_abs``).

    img: (B, C, H, W); py/px: (B, K, Ho, Wo) -> (B, C, K, Ho, Wo).
    """
    b, c, h, w = img.shape
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0).unsqueeze(1).to(img.dtype)
    wy = (py - y0).unsqueeze(1).to(img.dtype)
    x0i = x0.long()
    y0i = y0.long()
    flat = img.reshape(b, c, h * w)

    def gather(yy, xx):
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        lin = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        out = torch.gather(flat, 2, lin.reshape(b, 1, -1).expand(b, c, -1))
        return (out.reshape((b, c) + yy.shape[1:])
                * valid.unsqueeze(1).to(img.dtype))

    top = gather(y0i, x0i) * (1 - wx) + gather(y0i, x0i + 1) * wx
    bot = gather(y0i + 1, x0i) * (1 - wx) + gather(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy


class DeformConv(nn.Module):
    """3x3 deformable conv v1 (offsets only), conv groups=4, no bias.
    ``weight`` has the reference layout (G*Og, Cg, 3, 3); taps run
    row-major over the 3x3 window, offsets are (dy, dx) per tap."""

    def __init__(self, channels: int, groups: int = 4):
        super().__init__()
        self.groups = groups
        self.conv_offset = nn.Conv2d(channels, 18, 3, padding=1)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)
        self.weight = nn.Parameter(
            torch.empty(channels, channels // groups, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x):
        b, c, h, w = x.shape
        # sample positions in fp32 whatever the working dtype
        off = self.conv_offset(x).float().reshape(b, 9, 2, h, w)
        ky = torch.tensor(_KY, device=x.device).view(1, 9, 1, 1)
        kx = torch.tensor(_KX, device=x.device).view(1, 9, 1, 1)
        gy = torch.arange(h, dtype=torch.float32, device=x.device)
        gx = torch.arange(w, dtype=torch.float32, device=x.device)
        py = gy.view(1, 1, h, 1) + ky + off[:, :, 0]
        px = gx.view(1, 1, 1, w) + kx + off[:, :, 1]
        samp = bilinear_sample_abs(x, py, px)            # (B, C, 9, H, W)
        g = self.groups
        og, cg = self.weight.shape[0] // g, self.weight.shape[1]
        wgt = self.weight.reshape(g, og, cg * 9)
        samp = samp.reshape(b, g, cg * 9, h * w)
        out = torch.einsum("gon,bgnp->bgop", wgt, samp)
        return out.reshape(b, g * og, h, w)


class _DistributionNet(nn.Sequential):
    """The depth_conv Sequential (depthnet.py:216-244): 3 BasicBlocks +
    optional ASPP + optional DCN + 1x1 out conv; indices shift with the
    flags as in the reference's keys."""

    def __init__(self, mid: int, out_bins: int, cfg: DepthNetConfig):
        if cfg.stereo:
            raise NotImplementedError("stereo DepthNet is not ported yet")
        mods = [BasicBlock(mid, mid) for _ in range(3)]
        if cfg.use_aspp:
            mods.append(ASPP(mid, cfg.aspp_mid_channels
                             if cfg.aspp_mid_channels > 0 else mid,
                             dropout=cfg.aspp_dropout))
        if cfg.use_dcn:
            mods.append(DeformConv(mid))
        mods.append(nn.Conv2d(mid, out_bins, 1))
        super().__init__(*mods)


class HeightNet(nn.Module):
    """DepthNet minus the context branch (depthnet.py:418-652).

    forward(x (BN, C_in, fH, fW), mlp_input (BN, 27)) -> (BN, H, fH, fW)
    height logits.
    """

    def __init__(self, in_ch: int, mid: int, out_bins: int,
                 cfg: DepthNetConfig = DepthNetConfig()):
        super().__init__()
        self.reduce_conv = nn.Sequential(
            nn.Conv2d(in_ch, mid, 3, padding=1),
            nn.BatchNorm2d(mid), nn.ReLU(inplace=True))
        self.bn = nn.BatchNorm1d(27)
        self.depth_mlp = Mlp(27, mid, mid)
        self.depth_se = SELayer(mid)
        self.depth_conv = _DistributionNet(mid, out_bins, cfg)

    def forward(self, x, mlp_input):
        se = self.depth_mlp(self.bn(mlp_input))[..., None, None]
        h = self.depth_se(self.reduce_conv(x), se)
        return self.depth_conv(h)
