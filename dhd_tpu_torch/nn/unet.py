"""UNet voxel-slab encoder (models/backbones/unet.py:7-143): counterpart of
``dhd_tpu/nn/unet.py`` in NCHW.

Encoder base..16*base via maxpool + DoubleConv, decoder via ConvTranspose2d
(k2 s2) + skip concat + DoubleConv, 1x1 out conv.

On the card, in eval and where autograd records nothing, the passes
between the convolutions run as the epilogue kernels of
``ops/unet_epilogue.py`` (:meth:`UNet._forward_fused`), with the numbers
of the modules' chain; everywhere else the modules run as they are.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dhd_tpu_torch.ops.grad_mode import records_grad
from dhd_tpu_torch.ops.unet_epilogue import bn_relu_cuda, up_place_cuda

from .layers import BatchNorm2d, Conv2d, ConvTranspose2d


def _terms(bn: nn.BatchNorm2d):
    """An eval BatchNorm's running statistics, affine and epsilon."""
    return bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """``x`` channels-last, as the epilogue kernels take it: cuDNN's convs
    keep a channels-last input's layout, so on the card this copies
    nothing; a trace's shape-only convs may not."""
    return x.contiguous(memory_format=torch.channels_last)


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

    def fused(self, x: torch.Tensor, out: Optional[torch.Tensor] = None,
              pool: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The forward with each BatchNorm and its ReLU as one kernel; the
        second writes into ``out``'s first channels and with ``pool`` also
        pools (:func:`~dhd_tpu_torch.ops.unet_epilogue.bn_relu_cuda`, whose
        (out, pooled) it returns)."""
        conv1, bn1, _, conv2, bn2, _ = self.double_conv
        y, _ = bn_relu_cuda(_nhwc(conv1(x)), *_terms(bn1))
        return bn_relu_cuda(_nhwc(conv2(y)), *_terms(bn2), out=out,
                            pool=pool)


class Down(nn.Module):
    """2x2 max pool, stride 2, then DoubleConv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConv(cin, cout))

    def forward(self, x):
        return self.maxpool_conv(x)

    def fused(self, pooled: torch.Tensor, **kw):
        """:meth:`DoubleConv.fused` of an input the level above pooled."""
        return self.maxpool_conv[1].fused(pooled, **kw)


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

    def fused(self, x1: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
        """The forward into ``cat``, the concatenation's buffer whose first
        half already holds the skip: the transposed conv without its bias,
        then the bias, pad and copy as one kernel into the second half
        (:func:`~dhd_tpu_torch.ops.unet_epilogue.up_place_cuda`)."""
        up = self.up
        x1 = _nhwc(F.conv_transpose2d(
            x1, up.weight.to(x1.dtype), None, up.stride, up.padding,
            up.output_padding, up.groups, up.dilation))
        up_place_cuda(x1, up.bias.to(x1.dtype), cat)
        return self.conv.fused(cat)[0]


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
        b = self.base = base
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
        if self._takes_kernels(x):
            return self._forward_fused(x)
        return self._forward_modules(x)

    def _forward_modules(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` through the modules, pass by pass."""
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x = self.up1(self.down4(x4), x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        return self.outc(self.up4(x, x1))

    def _takes_kernels(self, x: torch.Tensor) -> bool:
        """Whether a call runs the epilogue kernels: on a CUDA tensor, in
        eval (the running statistics), where autograd records nothing (the
        kernels have no backward), at widths they take (multiples of 8:
        every base the presets give but the tiny ones' 4)."""
        return (x.is_cuda and not self.training and self.base % 8 == 0
                and not records_grad(x, *self.parameters()))

    def _forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` through the epilogue kernels, channels-last.
        Each level's concatenation buffer is allocated ahead: the level's
        DoubleConv writes its skip into the first half, and its max pool
        for the next level beside it, and the Up its upsampled half into
        the second.  Nothing else is written: no skip, pad or cat tensor."""
        x = _nhwc(x)
        n, _, h, w = x.shape
        cats = []
        for level in range(4):
            cats.append(torch.empty(
                (n, 2 * self.base << level, h, w), dtype=x.dtype,
                device=x.device, memory_format=torch.channels_last))
            h, w = h // 2, w // 2
        for enc, cat in zip((self.inc, self.down1, self.down2, self.down3),
                            cats):
            _, x = enc.fused(x, out=cat, pool=True)
        x, _ = self.down4.fused(x)
        for up, cat in zip((self.up1, self.up2, self.up3, self.up4),
                           reversed(cats)):
            x = up.fused(x, cat)
        return self.outc(x)
