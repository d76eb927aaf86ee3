"""Shared NN building blocks (NCHW), counterparts of ``dhd_tpu/nn/layers.py``.

Attribute names follow the reference's state_dict key space (the naming
template ``dhd_tpu/oracle/torch_ref.py`` uses), so a reference ``.pth`` or a
converted JAX checkpoint loads with ``strict=True``.  BatchNorm keeps
torch's keys and eval mode (eps 1e-5, running statistics); in training it
is flax's ``nn.BatchNorm`` (:class:`BatchNorm2d`).  Its affine and
statistics stay fp32 in a model cast to bf16, as flax's
``param_dtype=float32`` keeps them.

Convolutions and dense layers compute in their input's dtype
(:class:`Conv2d`, :class:`Linear`, :class:`ConvTranspose2d`), as flax's
``dtype`` makes them: a model whose fp32 weights see bf16 activations runs
a bf16 forward (mixed-precision training), and a model cast to bf16 runs
as before.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench_port.reference.parallel import (global_rand, global_sums,
                                         world_size)

# flax's BatchNorm momentum as the JAX package sets it (torch's 0.1)
FLAX_BN_MOMENTUM = 0.9


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype
          ) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def _fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the fp8 ``dtype`` under one per-tensor scale that
    puts its peak at the type's largest finite value, and back."""
    top = torch.finfo(dtype).max
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / top
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


class _FP8RoundTrip(torch.autograd.Function):
    """fp8 training's rounding: the operand in float8_e4m3fn on the way
    forward, its gradient in float8_e5m2 on the way back."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad, torch.float8_e5m2)


class _Precision:
    """The operands of a conv or dense layer: as they are, or, with
    ``fp8`` set (:func:`compute_operands_in_fp8`), each input and weight
    rounded to fp8 first: the lower-precision control of the benchmark's
    correctness check."""
    fp8 = False

    def _operands(self, x, w):
        if not self.fp8:
            return x, w
        return _FP8RoundTrip.apply(x), _FP8RoundTrip.apply(w)


def compute_operands_in_fp8(model: nn.Module, on: bool = True) -> None:
    """Every conv and dense layer of ``model`` rounds its input and weight
    to fp8 (or, with ``on`` False, no longer does)."""
    for m in model.modules():
        if isinstance(m, _Precision):
            m.fp8 = on


def _round_activations(module, args, out):
    """A forward hook: each bf16 (or fp16) tensor of ``out`` through
    :class:`_FP8RoundTrip`."""
    if isinstance(out, torch.Tensor):
        return (_FP8RoundTrip.apply(out)
                if out.dtype in (torch.bfloat16, torch.float16) else out)
    if isinstance(out, (tuple, list)):
        return type(out)(_round_activations(module, args, o) for o in out)
    if isinstance(out, dict):
        return {k: _round_activations(module, args, v)
                for k, v in out.items()}
    return out


def compute_in_fp8(model: nn.Module) -> None:
    """``model``, run with a bf16 compute dtype, computes in fp8 where it
    would hold bf16: every conv and dense layer's operands
    (:func:`compute_operands_in_fp8`) and every bf16 tensor a module
    returns are rounded to e4m3 on the way forward, their gradients to
    e5m2 on the way back.  What stays fp32 in a bf16 model (weights,
    BatchNorm's statistics, the geometry) stays fp32."""
    compute_operands_in_fp8(model)
    for m in model.modules():
        m.register_forward_hook(_round_activations)


class Conv2d(_Precision, nn.Conv2d):
    """torch's Conv2d computing in its input's dtype: the weight and bias
    are cast to it each call, as flax's ``nn.Conv(dtype=...)`` casts its
    kernel and bias.  Over fp32 master weights and bf16 activations the
    product is bf16 and the gradients reach the weights in fp32; a model
    cast whole casts nothing."""

    def forward(self, x):
        x, w = self._operands(x, self.weight.to(x.dtype))
        return self._conv_forward(x, w, _cast(self.bias, x.dtype))


class ConvTranspose2d(_Precision, nn.ConvTranspose2d):
    """torch's ConvTranspose2d computing in its input's dtype (as
    :class:`Conv2d`)."""

    def forward(self, x):
        x, w = self._operands(x, self.weight.to(x.dtype))
        return F.conv_transpose2d(
            x, w, _cast(self.bias, x.dtype),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation)


class Linear(_Precision, nn.Linear):
    """torch's Linear computing in its input's dtype (as :class:`Conv2d`;
    flax's ``nn.Dense(dtype=...)``)."""

    def forward(self, x):
        x, w = self._operands(x, self.weight.to(x.dtype))
        return F.linear(x, w, _cast(self.bias, x.dtype))


class _FlaxTrainBN:
    """The JAX package's ``BatchNorm`` (``dhd_tpu/nn/layers.py:23-36``,
    flax ``nn.BatchNorm`` with ``param_dtype=float32``).

    Its weight, bias and running statistics stay fp32 whatever dtype
    ``.to()`` asks for.  In eval mode torch's BatchNorm normalises a bf16
    input against them in fp32 and returns bf16, as flax does.

    The train-mode forward: statistics in fp32 (or wider) over every axis
    but the channels, the variance as ``max(0, E[x^2] - E[x]^2)``,
    ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias``, and the
    running statistics stepped with the *biased* batch variance,
    ``r = 0.9 r + 0.1 stat``.  torch's own BatchNorm steps them with the
    unbiased variance, and raises on one value per channel, where flax
    normalises to ``bias``.  Under a process group the sums of x and x^2
    are summed over every process first, by an all-reduce that autograd
    differentiates, and divided by the global batch's count: a SyncBN, as
    GSPMD makes every flax BatchNorm over a sharded batch.

    ``update_stats`` False keeps the running statistics as they are: a
    rematerialised block recomputed in the backward (:func:`remat`) must
    not step them a second time."""
    update_stats = True

    def _apply(self, fn, *args, **kwargs):
        def at_least_fp32(t):
            out = fn(t)
            if t.is_floating_point() and out.dtype != t.dtype:
                # cast the unrounded tensor: a bf16 round trip would round
                # the statistics
                return t.to(device=out.device, dtype=torch.promote_types(
                    out.dtype, torch.float32))
            return out
        return super()._apply(at_least_fp32, *args, **kwargs)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        s1, s2 = global_sums(xf.sum(dims), (xf * xf).sum(dims))
        # every process holds as many rows (process_batch_slice); a Python
        # count divides as in one process (CUDA multiplies by 1 / count)
        count = xf.numel() // xf.shape[1] * world_size()
        mean = s1 / count
        var = (s2 / count - mean * mean).clamp_min(0.0)
        if self.update_stats:
            with torch.no_grad():
                m = FLAX_BN_MOMENTUM
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
                self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class BatchNorm2d(_FlaxTrainBN, nn.BatchNorm2d):
    """BatchNorm over (B, C, H, W) with flax's train-mode statistics."""


class BatchNorm1d(_FlaxTrainBN, nn.BatchNorm1d):
    """BatchNorm over (B, C) rows with flax's train-mode statistics."""


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Inside, ``module``'s BatchNorms normalise with batch statistics in
    training but leave their running statistics alone."""
    bns = [m for m in module.modules() if isinstance(m, _FlaxTrainBN)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            del m.update_stats


def remat(module: Callable, *args):
    """``module(*args)`` whose activations are recomputed in the backward
    instead of kept (``torch.utils.checkpoint``), as flax's ``nn.remat``
    does; ``module`` is a module or a bound method of one.  flax's remat
    is functional, so the running statistics take one step; here the
    recomputation runs under :func:`frozen_stats`, and they too take one
    step, in the forward.  The recomputation restores torch's global RNG
    states but not a generator passed in: draw random masks before, and
    pass them in ``args``."""
    owner = getattr(module, "__self__", module)
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return module(*a)
        with frozen_stats(owner):
            return module(*a)
    return checkpoint(run, *args, use_reentrant=False)


class Dropout(nn.Dropout):
    """flax's ``nn.Dropout``: in training each element is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``, by a mask drawn
    from ``generator`` (on the input's device; torch's default generator
    when None) per global sample under a process group
    (:func:`~bench_port.reference.parallel.global_rand`)."""

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.p
        mask = global_rand(x.shape, generator, x.device) < keep
        return torch.where(mask, x / keep, 0.0)


class ConvBNReLU(nn.Module):
    """conv -> BN -> ReLU.  The attribute names are those of the
    reference's ``_ASPPModule`` (depthnet.py:10-40), its one user."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 dilation: int = 1):
        super().__init__()
        pad = dilation * (kernel - 1) // 2
        self.atrous_conv = Conv2d(cin, cout, kernel, padding=pad,
                                     dilation=dilation, bias=False)
        self.bn = BatchNorm2d(cout)

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
        self.conv1 = Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = downsample

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + idt)


def conv_basic_block(cin: int, cout: int, stride: int) -> BasicBlock:
    """BasicBlock whose skip branch is a bare 3x3 conv with bias."""
    return BasicBlock(cin, cout, stride,
                      downsample=Conv2d(cin, cout, 3, stride, 1))


def conv1x1_basic_block(cin: int, cout: int) -> BasicBlock:
    """BasicBlock whose skip branch is a 1x1 conv with bias (the stereo
    DepthNet's first block, depthnet.py:204-206)."""
    return BasicBlock(cin, cout, downsample=Conv2d(cin, cout, 1))


class Bottleneck(nn.Module):
    """torchvision/mmdet Bottleneck ('pytorch' style: stride on the 3x3)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, expansion: int = 4):
        super().__init__()
        cout = planes * expansion
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, bias=False),
                BatchNorm2d(cout))

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
        self.fc1 = Linear(cin, hidden)
        self.fc2 = Linear(hidden, cout)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class SELayer(nn.Module):
    """Camera-aware SE gate (depthnet.py:150-169): x * sigmoid(MLP(se)),
    with the MLP as 1x1 convs over a (B, C, 1, 1) embedding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = Conv2d(channels, channels, 1)
        self.conv_expand = Conv2d(channels, channels, 1)

    def forward(self, x, x_se):
        g = self.conv_expand(F.relu(self.conv_reduce(x_se)))
        return x * torch.sigmoid(g)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (depthnet.py:42-116): 1x1 and 3x3
    d6/d12/d18 branches plus a global-average branch, concat -> 1x1 conv ->
    BN -> ReLU -> dropout (an identity in eval; in training its mask comes
    from the ``generator`` of the call)."""

    def __init__(self, cin: int, mid: int, dropout: float = 0.5):
        super().__init__()
        self.aspp1 = ConvBNReLU(cin, mid, 1)
        self.aspp2 = ConvBNReLU(cin, mid, 3, dilation=6)
        self.aspp3 = ConvBNReLU(cin, mid, 3, dilation=12)
        self.aspp4 = ConvBNReLU(cin, mid, 3, dilation=18)
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d((1, 1)),
            Conv2d(cin, mid, 1, bias=False),
            BatchNorm2d(mid), nn.ReLU())
        self.conv1 = Conv2d(mid * 5, cin, 1, bias=False)
        self.bn1 = BatchNorm2d(cin)
        self.dropout = Dropout(dropout)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b4 = self.aspp4(x)
        g = self.global_avg_pool(x).expand(-1, -1, *b4.shape[2:])
        y = torch.cat([self.aspp1(x), self.aspp2(x), self.aspp3(x), b4, g],
                      dim=1)
        return self.dropout(F.relu(self.bn1(self.conv1(y))), generator)


def upsample_bilinear_align(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear x``scale`` upsample with align_corners=True: output pixel i
    samples the input at i*(in-1)/(out-1).  x: (B, C, H, W)."""
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(h * scale, w * scale), mode="bilinear",
                         align_corners=True)
