"""DepthNet and HeightNet with the deformable conv: counterpart of
``dhd_tpu/nn/depthnet.py`` (model_utils/depthnet.py:172-652).

A reduce conv, SE gates driven by the 27-dim camera embedding, 3
BasicBlocks + ASPP (+ deformable conv) + a 1x1 projection to the depth or
height bins, an optional stereo cost-volume input, and in DepthNet a
context branch.  The deformable conv is mmcv's DCN v1 as configured in
depthnet.py:226-236 (deform_groups=1, conv groups=4, zero-init offsets),
written as plain-torch bilinear sampling.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from dhd_tpu_torch.config import DepthNetConfig
from dhd_tpu_torch.device import device_constant
from .layers import (ASPP, BasicBlock, BatchNorm1d, BatchNorm2d, Conv2d,
                     Mlp, SELayer, conv1x1_basic_block)

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
        self.conv_offset = Conv2d(channels, 18, 3, padding=1)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)
        self.weight = nn.Parameter(
            torch.empty(channels, channels // groups, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x):
        b, c, h, w = x.shape
        # sample positions in fp32 whatever the working dtype
        off = self.conv_offset(x).float().reshape(b, 9, 2, h, w)
        ky = device_constant(_KY, x.device).view(1, 9, 1, 1)
        kx = device_constant(_KX, x.device).view(1, 9, 1, 1)
        gy = torch.arange(h, dtype=torch.float32, device=x.device)
        gx = torch.arange(w, dtype=torch.float32, device=x.device)
        py = gy.view(1, 1, h, 1) + ky + off[:, :, 0]
        px = gx.view(1, 1, 1, w) + kx + off[:, :, 1]
        samp = bilinear_sample_abs(x, py, px)            # (B, C, 9, H, W)
        g = self.groups
        og, cg = self.weight.shape[0] // g, self.weight.shape[1]
        wgt = self.weight.to(x.dtype).reshape(g, og, cg * 9)
        samp = samp.reshape(b, g, cg * 9, h * w)
        out = torch.einsum("gon,bgnp->bgop", wgt, samp)
        return out.reshape(b, g * og, h, w)


class EmbeddingBN(BatchNorm1d):
    """The camera embedding's BatchNorm (``mlp_bn``), which also takes its
    input in fp32 whatever the model's dtype, as the JAX package does
    (``dhd_tpu/nn/depthnet.py:187,219``).  The embedding holds intrinsics
    of ~557 px, where a bf16 step is 4: with trained running statistics a
    bf16 BN cancels to whole units away from the fp32 answer."""


class _DistributionNet(nn.Sequential):
    """The depth_conv Sequential (depthnet.py:216-244): 3 BasicBlocks +
    optional ASPP + optional DCN + 1x1 out conv; indices shift with the
    flags as in the reference's keys.  In a stereo net the first block
    takes the features and the reduced cost volume concatenated, with a
    1x1 conv skip.  The ASPP's dropout draws from the call's
    ``generator``."""

    def __init__(self, mid: int, out_bins: int, cfg: DepthNetConfig):
        if cfg.stereo:
            mods = [conv1x1_basic_block(mid + out_bins, mid)]
        else:
            mods = [BasicBlock(mid, mid)]
        mods += [BasicBlock(mid, mid) for _ in range(2)]
        if cfg.use_aspp:
            mods.append(ASPP(mid, cfg.aspp_mid_channels
                             if cfg.aspp_mid_channels > 0 else mid,
                             dropout=cfg.aspp_dropout))
        if cfg.use_dcn:
            mods.append(DeformConv(mid))
        mods.append(Conv2d(mid, out_bins, 1))
        super().__init__(*mods)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for mod in self:
            x = mod(x, generator) if isinstance(mod, ASPP) else mod(x)
        return x


class HeightNet(nn.Module):
    """DepthNet minus the context branch (depthnet.py:418-652).

    forward(x (BN, C_in, fH, fW), mlp_input (BN, 27) fp32, cost_volume,
    generator) -> (BN, H, fH, fW) logits; ``generator`` draws the ASPP's
    dropout mask in training.  With ``cfg.stereo`` the (BN, H, 4fH, 4fW)
    cost volume goes through ``cost_volumn_net`` (two stride-2 3x3 convs
    with BN; the reference's spelling) and joins the features before
    ``depth_conv``.
    """

    def __init__(self, in_ch: int, mid: int, out_bins: int,
                 cfg: DepthNetConfig = DepthNetConfig()):
        super().__init__()
        self.stereo = cfg.stereo
        self.reduce_conv = nn.Sequential(
            Conv2d(in_ch, mid, 3, padding=1),
            BatchNorm2d(mid), nn.ReLU(inplace=True))
        self.bn = EmbeddingBN(27)
        self.depth_mlp = Mlp(27, mid, mid)
        self.depth_se = SELayer(mid)
        if cfg.stereo:
            self.cost_volumn_net = nn.Sequential(
                Conv2d(out_bins, out_bins, 3, 2, 1),
                BatchNorm2d(out_bins),
                Conv2d(out_bins, out_bins, 3, 2, 1),
                BatchNorm2d(out_bins))
        self.depth_conv = _DistributionNet(mid, out_bins, cfg)

    def _embed(self, x, mlp_input):
        """Reduced features and the normalised embedding: the BN runs in
        fp32 and its output meets the working dtype after it."""
        mlp = self.bn(mlp_input.float()).to(x.dtype)
        return self.reduce_conv(x), mlp

    def _distribution(self, h, cost_volume, generator):
        if self.stereo:
            if cost_volume is None:
                raise ValueError("a stereo net needs a cost volume")
            h = torch.cat([h, self.cost_volumn_net(cost_volume)], dim=1)
        return self.depth_conv(h, generator)

    def forward(self, x, mlp_input, cost_volume=None, generator=None):
        x, mlp = self._embed(x, mlp_input)
        h = self.depth_se(x, self.depth_mlp(mlp)[..., None, None])
        return self._distribution(h, cost_volume, generator)


class DepthNet(HeightNet):
    """The full BEVDepth-style DepthNet (depthnet.py:172-415).

    forward(x, mlp_input, cost_volume) -> (BN, D + C_context, fH, fW):
    depth logits first, then the context features.
    """

    def __init__(self, in_ch: int, mid: int, context_ch: int, depth_bins: int,
                 cfg: DepthNetConfig = DepthNetConfig()):
        super().__init__(in_ch, mid, depth_bins, cfg)
        self.context_mlp = Mlp(27, mid, mid)
        self.context_se = SELayer(mid)
        self.context_conv = Conv2d(mid, context_ch, 1)

    def forward(self, x, mlp_input, cost_volume=None, generator=None):
        x, mlp = self._embed(x, mlp_input)
        context = self.context_conv(
            self.context_se(x, self.context_mlp(mlp)[..., None, None]))
        h = self.depth_se(x, self.depth_mlp(mlp)[..., None, None])
        return torch.cat([self._distribution(h, cost_volume, generator),
                          context], dim=1)
