"""Post-training int8 quantization for serving (the TRT-int8 analogue):
counterpart of ``dhd_tpu/nn/quant.py``, with the same maths keyed by the
port's module names.

* **Calibration** (:func:`calibrate_int8`): run the fp model over a few
  batches and record the absolute maximum of every targeted conv's input
  (per-tensor symmetric activation scales, the TRT default for feature
  maps).  The targets are the ``nn.Conv2d`` layers with ``groups == 1``
  whose names start with a prefix; the default, ``img_backbone``, is the
  JAX package's ``img_encoder/backbone`` (``dhd_tpu/cli/export.py:28``) in
  the reference's key space.
* **Quantized serving** (:func:`quantize_model`): a copy of the model with
  each targeted conv an :class:`Int8Conv2d`, JAX's ``int8_interceptor``
  step for step: activations quantized per tensor with the calibrated
  scale, weights per output channel from the fp weights on every call (so
  the weights file stays the fp ``state_dict``), the product int8 x int8
  -> int32, dequantized in fp32 plus the fp32 bias, cast to the conv's
  compute dtype.

The int8 conv is XLA's conv in the JAX package, not a Pallas kernel; here
it is an im2col into ``torch._int_mm`` on every device
(:func:`int8_conv_int32`).  The int32 sums are exact (at most
127^2 * 4,608 ~ 7.4e7 at ResNet-50's 3x3x512), so on the same int8 inputs
they equal JAX's bit for bit, and only the fp32 dequantization may differ.
Scales ride in a plain ``{module name: amax}`` dict.
"""
from __future__ import annotations

import copy
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dhd_tpu_torch.nn.layers import Conv2d

DEFAULT_PREFIXES = ("img_backbone",)


def targeted_convs(model: nn.Module, prefixes: Sequence[str]
                   ) -> Dict[str, nn.Conv2d]:
    """The convs that int8 serving replaces, by module name."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, nn.Conv2d) and m.groups == 1
            and any(name.startswith(p) for p in prefixes)}


@torch.no_grad()
def calibrate_int8(model: nn.Module, batches: Iterable,
                   prefixes: Sequence[str] = DEFAULT_PREFIXES
                   ) -> Dict[str, torch.Tensor]:
    """Run ``model(batch)`` over ``batches`` recording the absmax of each
    targeted conv's input, by forward pre-hooks.  Returns
    ``{module name: amax}``, fp32 0-dim tensors on the CPU.

    The JAX package calibrates a remat-free twin of the model (its side
    dict would hold tracers of a checkpointed trace).  The port needs
    none: its eval forward recomputes nothing, and a hook sees the real
    tensors."""
    amax: Dict[str, torch.Tensor] = {}

    def record(name, x):
        a = x.detach().float().abs().amax()
        amax[name] = torch.maximum(amax[name], a) if name in amax else a

    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: record(name, args[0]))
        for name, m in targeted_convs(model, prefixes).items()]
    try:
        for batch in batches:
            model(batch)
    finally:
        for h in hooks:
            h.remove()
    return {k: v.cpu() for k, v in amax.items()}


def int8_conv_int32(xq: torch.Tensor, wq: torch.Tensor,
                    stride: Tuple[int, int], padding: Tuple[int, int],
                    dilation: Tuple[int, int]) -> torch.Tensor:
    """int8 (B, Cin, H, W) x int8 (Co, Cin, kh, kw) -> int32 (B, Ho, Wo,
    Co): the conv as an im2col (K = Cin*kh*kw, padded with zeros to a
    multiple of 8, and Co to one too) into ``torch._int_mm``."""
    b, cin, _, _ = xq.shape
    co, _, kh, kw = wq.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    if ph or pw:
        xq = F.pad(xq, (pw, pw, ph, ph))
    cols = xq.unfold(2, (kh - 1) * dh + 1, sh).unfold(3, (kw - 1) * dw + 1,
                                                      sw)
    if dh > 1 or dw > 1:
        cols = cols[..., ::dh, ::dw]
    ho, wo = cols.shape[2:4]
    k = cin * kh * kw
    a = cols.permute(0, 2, 3, 1, 4, 5).reshape(b * ho * wo, k)
    w = wq.reshape(co, k)
    kp, cp = -(-k // 8) * 8, -(-co // 8) * 8
    if kp != k:
        a = F.pad(a, (0, kp - k))
    if kp != k or cp != co:
        w = F.pad(w, (0, kp - k, 0, cp - co))
    acc = torch._int_mm(a, w.t())
    return acc[:, :co].reshape(b, ho, wo, co)


def int8_conv_int32_plain(xq: torch.Tensor, wq: torch.Tensor,
                          stride: Tuple[int, int], padding: Tuple[int, int],
                          dilation: Tuple[int, int]) -> torch.Tensor:
    """Plain version of :func:`int8_conv_int32`: the conv in float64,
    exact for these sums (below 2^53), as int32 (B, Ho, Wo, Co)."""
    y = F.conv2d(xq.double(), wq.double(), None, stride, padding, dilation)
    return y.to(torch.int32).permute(0, 2, 3, 1)


def activation_scale(amax: float) -> float:
    """The activation step ``max(amax, 1e-12) / 127`` in fp32 arithmetic,
    as JAX computes it (an fp32 value, which torch takes unchanged)."""
    return float(np.maximum(np.float32(amax), np.float32(1e-12))
                 / np.float32(127.0))


class Int8Conv2d(Conv2d):
    """A targeted conv run as int8 x int8 -> int32 (JAX's
    ``int8_interceptor``, ``dhd_tpu/nn/quant.py:78-114``), with the same
    parameters and state_dict keys as the conv it replaces and its
    calibrated input ``amax``."""
    amax: float

    @classmethod
    def from_conv(cls, conv: nn.Conv2d, amax: float) -> "Int8Conv2d":
        q = copy.copy(conv)
        q.__class__ = cls
        q.amax = float(amax)
        return q

    def quantized_weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(int8 weight, fp32 per-output-channel scale) from the fp
        weight."""
        wf = self.weight.float()
        sw = wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
        wq = torch.clamp(torch.round(wf / sw[:, None, None, None]),
                         -127, 127).to(torch.int8)
        return wq, sw

    def forward(self, x):
        sx = activation_scale(self.amax)
        xq = torch.clamp(torch.round(x.float() / sx), -127, 127).to(
            torch.int8)
        wq, sw = self.quantized_weight()
        acc = int8_conv_int32(xq, wq, self.stride, self.padding,
                              self.dilation)
        y = acc.float() * (sw * sx)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype).permute(0, 3, 1, 2).contiguous()


def quantize_model(model: nn.Module, scales: Dict[str, torch.Tensor],
                   prefixes: Sequence[str] = DEFAULT_PREFIXES) -> nn.Module:
    """A copy of ``model`` whose targeted convs with a scale in ``scales``
    are :class:`Int8Conv2d` (its state_dict keys unchanged)."""
    model = copy.deepcopy(model)
    for name, conv in targeted_convs(model, prefixes).items():
        if name not in scales:
            continue
        parent, _, child = name.rpartition(".")
        owner = model.get_submodule(parent) if parent else model
        setattr(owner, child, Int8Conv2d.from_conv(conv, scales[name]))
    return model
