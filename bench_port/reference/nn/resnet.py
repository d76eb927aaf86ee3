"""Image backbone (ResNet-50), BEV-encoder backbone (CustomResNet) and the
TinyCNN test backbone: counterparts of ``dhd_tpu/nn/resnet.py`` in NCHW.

ResNet-50 follows the torchvision layout of the reference's mmdet ``ResNet``
(DHD-S.py:44-55, style='pytorch'); CustomResNet mirrors
models/backbones/resnet.py:11-80 (stride-2 stages of BasicBlocks whose skip
branch is a bare 3x3 conv).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BasicBlock, BatchNorm2d, Bottleneck, Conv2d,
                     conv_basic_block, remat)


class ResNet50(nn.Module):
    """torchvision-style ResNet-50 trunk returning the stage outputs in
    ``out_indices`` (stage i has 256*2**i channels at stride 4*2**i).
    With ``remat``, a training call recomputes each bottleneck in the
    backward (the reference's ``with_cp=True``, DHD-S.py:52; JAX
    ``dhd_tpu/nn/resnet.py:38-42``)."""

    def __init__(self, out_indices: Tuple[int, ...] = (2, 3),
                 layers: Tuple[int, ...] = (3, 4, 6, 3),
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.out_indices = tuple(out_indices)
        self.out_channels = tuple(256 * 2 ** i for i in self.out_indices)
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin, planes = 64, 64
        for stage, n in enumerate(layers):
            stride = 1 if stage == 0 else 2
            self.add_module(f"layer{stage + 1}", nn.Sequential(*[
                Bottleneck(cin if b == 0 else planes * 4, planes,
                           stride=stride if b == 0 else 1,
                           downsample=(b == 0))
                for b in range(n)]))
            cin = planes * 4
            planes *= 2
        self.num_stages = len(layers)

    def forward(self, x, stage0_only: bool = False,
                generator: Optional[torch.Generator] = None):
        """The stage outputs in ``out_indices``; with ``stage0_only`` the
        stride-4 ``layer1`` output alone (the stereo extra-reference
        frame's path, bevstereo4d.py:20-40).  ``generator`` is unused: it
        is the image backbones' shared signature (the Swin draws from
        it)."""
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        rematted = self.remat and self.training and torch.is_grad_enabled()
        outs = []
        for stage in range(self.num_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                x = remat(block, x) if rematted else block(x)
            if stage0_only:
                return x
            if stage in self.out_indices:
                outs.append(x)
        return outs


class CustomResNet(nn.Module):
    """BEV-encoder backbone: stages of BasicBlocks; returns every stage's
    output (models/backbones/resnet.py:11-80)."""

    def __init__(self, cin: int, num_channels: Sequence[int] = (128, 256, 512),
                 num_layer: Sequence[int] = (2, 2, 2),
                 stride: Sequence[int] = (2, 2, 2)):
        super().__init__()
        stages = []
        for ch, n, s in zip(num_channels, num_layer, stride):
            blocks = [conv_basic_block(cin, ch, s)]
            blocks += [BasicBlock(ch, ch) for _ in range(n - 1)]
            stages.append(nn.Sequential(*blocks))
            cin = ch
        self.layers = nn.ModuleList(stages)

    def forward(self, x) -> List[torch.Tensor]:
        feats = []
        for stage in self.layers:
            x = stage(x)
            feats.append(x)
        return feats


class TinyCNN(nn.Module):
    """Small conv backbone standing in for ResNet-50 in the tiny presets:
    stride-2 BasicBlocks, emitting features at stride 16 and 32, and with
    ``emit_stereo`` first the stride-4 feature."""

    def __init__(self, channels: Sequence[int] = (16, 32, 64, 128),
                 emit_stereo: bool = False):
        super().__init__()
        cin = 3
        for i, ch in enumerate(channels):
            self.add_module(f"b{i}", conv_basic_block(cin, ch, 2))
            cin = ch
        self.b_last = conv_basic_block(cin, channels[-1], 2)
        self.num_blocks = len(channels)
        self.emit_stereo = emit_stereo
        self.out_channels = ((channels[1],) if emit_stereo else ()) + (
            channels[-1], channels[-1])

    def forward(self, x, stage0_only: bool = False,
                generator: Optional[torch.Generator] = None):
        """The features listed in ``out_channels``; with ``stage0_only``
        the stride-4 feature alone.  ``generator`` is unused, as in
        :class:`ResNet50`."""
        outs = []
        for i in range(self.num_blocks):
            x = getattr(self, f"b{i}")(x)
            if i == 1:                                   # stride 4
                if stage0_only:
                    return x
                if self.emit_stereo:
                    outs.append(x)
        return outs + [x, self.b_last(x)]                # stride 16, 32
