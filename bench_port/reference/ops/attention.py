"""Swin window attention in plain PyTorch: the port's
``window_attention_plain`` (the JAX package's XLA composition), frozen."""
from __future__ import annotations

import functools
from typing import Optional

import torch


@functools.lru_cache(maxsize=None)
def attention_scale(hd: int, dtype: torch.dtype) -> float:
    """``hd ** -0.5`` rounded to ``dtype``."""
    return float(torch.tensor(hd ** -0.5, dtype=dtype))


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor], heads: int
                           ) -> torch.Tensor:
    """softmax(q k^T * hd^-1/2 + bias[h] + mask[w % nW]) v per window w and
    head h of the qkv Linear's (W, N, 3C) output, in qkv's dtype with the
    softmax in fp32.  bias (heads, N, N); mask (nW, N, N) or None."""
    w, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    dt = qkv.dtype
    q, k, v = qkv.reshape(w, n, 3, heads, hd).unbind(2)    # (W, N, h, hd)
    q = q * attention_scale(hd, dt)
    attn = torch.einsum("bnhd,bmhd->bhnm", q, k) + bias[None].to(dt)
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(w // nw, nw, heads, n, n)
                + mask[None, :, None].to(dt)).reshape(w, heads, n, n)
    attn = torch.softmax(attn.float(), dim=-1).to(dt)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(w, n, c)
