"""The Swin's LayerNorm in plain PyTorch: the port's ``layer_norm_plain``
(the JAX package's one-pass formula, eps 1e-6), frozen."""
from __future__ import annotations

import torch


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics, cast to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()
    return y.to(x.dtype)
