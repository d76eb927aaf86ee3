"""The benchmark's seeded weights, made on the device in a few large calls.

The scales are the port's LeCun-normal init (``models/dhd.py:init_weights``
when the benchmark was defined), frozen here: convs and dense layers
normal(0, gain/fan_in) with the traffic mix's ``weight_gain`` (1 is the
port's own scale), the deformable convs' kernels normal(0, 2/fan_in),
zero biases and zero DCN offset convs, identity BatchNorms (weight 1,
bias 0, running mean 0, variance 1), LayerNorm weight 1 and bias 0, the
Swin's relative-position bias tables truncated-normal(0.02).  Which
parameter is which is read from the reference's modules, built on the
``meta`` device: the port and the reference share the state-dict keys,
and the port loads the result with ``strict=True``.

Every normal leaf comes from one ``torch.randn`` call and every truncated
one from one ``torch.rand`` call on a generator on the card, seeded from
``--seed``: the same seed gives the same weights on the same device.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from bench_port.reference.config import ModelConfig
from bench_port.reference.models import build_model
from bench_port.reference.nn.depthnet import DeformConv
from bench_port.reference.nn.swin import FusedLayerNorm, WindowMSA

TRUNC_STD = 0.02


def _leaves(cfg: ModelConfig, gain: float = 1.0):
    """(normal, truncated, fixed): state-dict keys with their normal
    scale, keys of truncated-normal leaves, and every other key with the
    constant it holds; and the shapes and dtypes of every key."""
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    normal: Dict[str, float] = {}
    trunc = []
    fixed: Dict[str, float] = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            if name.endswith("conv_offset"):
                fixed[pre + "weight"] = 0.0
            else:
                fan_in = (w.shape[0] * w[0, 0].numel()
                          if isinstance(mod, nn.ConvTranspose2d)
                          else w[0].numel())
                normal[pre + "weight"] = math.sqrt(gain / fan_in)
            if mod.bias is not None:
                fixed[pre + "bias"] = 0.0
        elif isinstance(mod, DeformConv):
            fan_in = mod.weight[0].numel() * mod.groups
            normal[pre + "weight"] = math.sqrt(2.0 / fan_in)
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            fixed.update({pre + "weight": 1.0, pre + "bias": 0.0,
                          pre + "running_mean": 0.0,
                          pre + "running_var": 1.0,
                          pre + "num_batches_tracked": 0})
        elif isinstance(mod, FusedLayerNorm):
            fixed.update({pre + "weight": 1.0, pre + "bias": 0.0})
        elif isinstance(mod, WindowMSA):
            trunc.append(pre + "relative_position_bias_table")
    meta = {k: (tuple(t.shape), t.dtype)
            for k, t in model.state_dict().items()}
    missing = set(meta) - set(normal) - set(trunc) - set(fixed)
    if missing:
        raise ValueError(f"no init rule for {sorted(missing)[:8]}")
    return normal, trunc, fixed, meta


def make_weights(cfg: ModelConfig, seed: int, device: torch.device,
                 dtype: torch.dtype = torch.float32, gain: float = 1.0
                 ) -> Dict[str, torch.Tensor]:
    """The state dict of ``cfg`` from ``seed`` on ``device``: float leaves
    in ``dtype`` (the type they are served or trained in), integer
    buffers as they are.  ``gain`` scales the variance of the convs' and
    dense layers' kernels: 1 is the port's LeCun scale, 2 He's."""
    normal, trunc, fixed, meta = _leaves(cfg, gain)
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = [k for k in meta if k in normal]
    sizes = [math.prod(meta[k][0]) for k in keys]
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for k, part in zip(keys, draw.split(sizes)):
        out[k] = (part * normal[k]).reshape(meta[k][0]).to(dtype)
    del draw
    keys = [k for k in meta if k in trunc]
    sizes = [math.prod(meta[k][0]) for k in keys]
    if keys:
        # a standard normal cut at +-2 by inverting the normal CDF, scaled
        # to TRUNC_STD (flax's truncated_normal)
        lo, hi = (0.5 * (1 + math.erf(z / math.sqrt(2))) for z in (-2., 2.))
        u = torch.rand(sum(sizes), generator=gen, device=device,
                       dtype=torch.float64)
        z = torch.erfinv(2 * (lo + u * (hi - lo)) - 1) * math.sqrt(2)
        z = (z * (TRUNC_STD / 0.87962566103423978)).float()
        for k, part in zip(keys, z.split(sizes)):
            out[k] = part.reshape(meta[k][0]).to(dtype)
    for k, value in fixed.items():
        shape, kind = meta[k]
        kind = dtype if kind.is_floating_point else kind
        out[k] = torch.full(shape, value, dtype=kind, device=device)
    return {k: out[k] for k in meta}
