"""Swin Transformer backbone (DHD-L's Swin-B): counterpart of
``dhd_tpu/nn/swin.py`` (the reference's mmcv-flavoured Swin,
models/backbones/swin.py:680-976).

4x4 conv patch embed + LayerNorm, stages of W-MSA / SW-MSA blocks with a
relative position bias, unfold-ordered PatchMerging, LayerNorm heads on the
``out_indices`` stages, and with ``return_stereo_feat`` first the stage-0
(stride-4, un-normed) feature for the stereo cost volume.  In training each
block drops its two residual branches per image (DropPath, rates rising
linearly to ``drop_path_rate``; masks from the call's generator) and, with
``remat``, is recomputed in the backward.

Window attention runs kernel B4 (``ops/window_attention.py``) and every
LayerNorm kernel B5 (``ops/layer_norm.py``) unless the module is built
with ``attn_kernel`` / ``ln_kernel`` off, or autograd records the call: the
kernels have no backward, so a call that needs gradients takes the plain
version, as the JAX package runs its kernels only when ``not train``
(``dhd_tpu/nn/swin.py:226,261``).  On CPU tensors the wrappers take their
plain versions.  Module attributes follow the reference's key space
(``patch_embed.{projection,norm}``, ``stages.i.blocks.j.{norm1,
attn.w_msa.{relative_position_bias_table,qkv,proj},norm2,ffn.layers.0.0,
ffn.layers.1}``, ``stages.i.downsample.{norm,reduction}``, ``norm{i}``).
Tokens run as (B, L, C) rows; the module takes (B, 3, H, W) images and
returns NCHW maps.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dhd_tpu_torch.ops.grad_mode import records_grad
from dhd_tpu_torch.ops.layer_norm import (fused_layer_norm_cuda,
                                          layer_norm_plain)
from dhd_tpu_torch.ops.window_attention import (window_attention_cuda,
                                                window_attention_plain)
from dhd_tpu_torch.parallel.mesh import global_rand
from .layers import Conv2d, Linear, remat


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nH*nW, ws*ws, C); H, W divisible by ws."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, h: int, w: int
                   ) -> torch.Tensor:
    """The inverse of :func:`window_partition`: -> (B, h, w, C)."""
    b = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


@functools.lru_cache(maxsize=None)
def _window_perms(hp: int, wp: int, h: int, w: int, ws: int,
                  shift: int) -> Tuple[np.ndarray, np.ndarray]:
    """Row permutations replacing roll + window_partition and
    window_reverse + unroll + crop (dhd_tpu/nn/swin.py:41-76).

    Returns (fwd, inv): ``fwd[widx*N + n]`` is the row of the padded
    (hp, wp) map feeding element n of window widx (shift applied);
    ``inv[i*w + j]`` is the (widx*N + n) row of the window tensor that lands
    at cropped output position (i, j).
    """
    nw_w = wp // ws
    wi, pi, wj, pj = np.meshgrid(
        np.arange(hp // ws), np.arange(ws), np.arange(nw_w),
        np.arange(ws), indexing="ij")
    src = (((wi * ws + pi + shift) % hp) * wp
           + (wj * ws + pj + shift) % wp)           # (nH, ws, nW, ws)
    fwd = src.transpose(0, 2, 1, 3).reshape(-1)     # widx-major, N inner
    i, j = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ri, rj = (i - shift) % hp, (j - shift) % wp
    inv = ((ri // ws * nw_w + rj // ws) * (ws * ws)
           + (ri % ws) * ws + rj % ws).reshape(-1)
    return fwd.astype(np.int32), inv.astype(np.int32)


def _relative_position_index(ws: int) -> np.ndarray:
    """(N, N) index into the ((2ws-1)^2, heads) bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))           # (2, ws, ws)
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """SW-MSA attention mask (swin.py:423-443): (nW, N, N) of {0, -100}."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wcs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wcs] = cnt
            cnt += 1
    m = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    m = m.reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_perms(hp: int, wp: int, h: int, w: int, ws: int, shift: int,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_window_perms` on ``device``, copied once per shape."""
    return tuple(torch.from_numpy(p.astype(np.int64)).to(device)
                 for p in _window_perms(hp, wp, h, w, ws, shift))


@functools.lru_cache(maxsize=None)
def _device_shift_mask(hp: int, wp: int, ws: int, shift: int,
                       device: torch.device, dtype: torch.dtype
                       ) -> torch.Tensor:
    """:func:`_shift_attn_mask` on ``device`` in ``dtype``, copied once per
    shape."""
    return torch.from_numpy(_shift_attn_mask(hp, wp, ws, shift)).to(
        device=device, dtype=dtype)


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis with the JAX package's numerics (one-pass
    fp32 statistics, eps 1e-6): kernel B5, or its plain version with
    ``kernel=False`` or under autograd.  ``weight`` / ``bias`` stay fp32 in a bf16 model, as
    the JAX package keeps them (dhd_tpu/nn/swin.py:120-121)."""

    def __init__(self, channels: int, eps: float = 1e-6, kernel: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps
        self.kernel = kernel

    def _apply(self, fn, *args, **kwargs):
        super()._apply(fn, *args, **kwargs)
        return super()._apply(
            lambda t: t.float() if t.is_floating_point() else t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = (fused_layer_norm_cuda
              if self.kernel and not records_grad(x, self.weight, self.bias)
              else layer_norm_plain)
        return fn(x, self.weight, self.bias, self.eps)


class WindowMSA(nn.Module):
    """Window multi-head self-attention with a relative position bias over
    (W, N, C) windows: the qkv Linear, kernel B4 (or its plain version with
    ``kernel=False`` or under autograd), the output projection."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 kernel: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.kernel = kernel
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window_size)
                             .reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        n = x.shape[1]
        qkv = self.qkv(x)
        bias = self.relative_position_bias_table[
            self.relative_position_index].reshape(n, n, self.num_heads)
        bias = bias.permute(2, 0, 1).to(qkv.dtype).contiguous()
        fn = (window_attention_cuda
              if self.kernel and not records_grad(qkv, bias)
              else window_attention_plain)
        return self.proj(fn(qkv, bias, mask, self.num_heads))


class ShiftWindowMSA(nn.Module):
    """Pad, (cyclic shift +) partition into windows, window attention, and
    back (mmcv's ShiftWindowMSA, holding ``w_msa``).  The shift, the
    partition, the reverse and the crop are one row gather each, with
    indices built once per shape and device."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: bool, kernel: bool = True):
        super().__init__()
        self.window_size = window_size
        self.shift = window_size // 2 if shift else 0
        self.w_msa = WindowMSA(dim, num_heads, window_size, kernel)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        """x (B, L, C) normed tokens of an (h, w) map -> (B, L, C)."""
        h, w = hw
        b, _, c = x.shape
        ws = self.window_size
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        y = x.reshape(b, h, w, c)
        if pad_b or pad_r:             # padded tokens are exact zeros
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        fwd, inv = _device_perms(hp, wp, h, w, ws, self.shift, x.device)
        mask = (_device_shift_mask(hp, wp, ws, self.shift, x.device, x.dtype)
                if self.shift else None)
        wins = y.reshape(b, hp * wp, c).index_select(1, fwd)
        wins = self.w_msa(wins.reshape(-1, ws * ws, c), mask)
        return wins.reshape(b, -1, c).index_select(1, inv)


class FFN(nn.Module):
    """mmcv FFN: Linear -> exact GELU -> Linear (``layers.0.0``,
    ``layers.1``)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Linear(dim, hidden), nn.GELU()),
            Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class DropPath(nn.Module):
    """Stochastic depth (dhd_tpu/nn/swin.py:134-145): in training each
    image of the (B, L, C) batch keeps its residual branch with
    probability ``1 - rate``, scaled by ``1 / (1 - rate)``; the identity
    in eval mode and at rate 0.  The mask is drawn (:meth:`draw`) apart
    from its use, so that a recomputed block reuses it."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def draw(self, x: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> Optional[torch.Tensor]:
        """The (B, 1, 1) keep mask of ``x``'s images from ``generator`` (on
        x's device; torch's default generator when None), drawn per global
        image under a process group
        (:func:`~dhd_tpu_torch.parallel.global_rand`), or None where the
        branch is kept whole."""
        if not self.training or self.rate == 0.0:
            return None
        return global_rand((x.shape[0], 1, 1), generator,
                           x.device) < 1.0 - self.rate

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        if mask is None:
            return x
        return x * mask.to(x.dtype) / (1.0 - self.rate)


class SwinBlock(nn.Module):
    """x + DropPath(SW-MSA(norm1(x))), then x + DropPath(FFN(norm2(x))).
    With ``remat`` a training call is recomputed in the backward
    (``nn.remat(SwinBlock)``, dhd_tpu/nn/swin.py:343)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: bool, mlp_ratio: int = 4, attn_kernel: bool = True,
                 ln_kernel: bool = True, drop_path: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.norm1 = FusedLayerNorm(dim, kernel=ln_kernel)
        self.attn = ShiftWindowMSA(dim, num_heads, window_size, shift,
                                   attn_kernel)
        self.norm2 = FusedLayerNorm(dim, kernel=ln_kernel)
        self.ffn = FFN(dim, dim * mlp_ratio)
        self.dp1 = DropPath(drop_path)
        self.dp2 = DropPath(drop_path)
        self.remat = remat

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Both DropPath masks are drawn from ``generator`` before the
        block runs: the recomputation of a rematerialised block reuses
        them (and the generator steps once a call)."""
        masks = (self.dp1.draw(x, generator), self.dp2.draw(x, generator))
        if self.remat and self.training and torch.is_grad_enabled():
            return remat(self._residuals, x, hw, *masks)
        return self._residuals(x, hw, *masks)

    def _residuals(self, x: torch.Tensor, hw: Tuple[int, int],
                   mask1: Optional[torch.Tensor],
                   mask2: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.dp1(self.attn(self.norm1(x), hw), mask1)
        return x + self.dp2(self.ffn(self.norm2(x)), mask2)


class PatchMerging(nn.Module):
    """Unfold-ordered 2x2 merge, channel ``c*4 + ky*2 + kx``
    (swin.py:216-241; not timm's [x0, x1, x2, x3] concat), zero-padding odd
    sides, then LayerNorm and Linear(4C -> 2C, no bias)."""

    def __init__(self, dim: int, ln_kernel: bool = True):
        super().__init__()
        self.norm = FusedLayerNorm(4 * dim, kernel=ln_kernel)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]
                ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        h, w = hw
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        h2, w2 = (h + 1) // 2, (w + 1) // 2
        x = x.reshape(b, h2, 2, w2, 2, c).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, h2 * w2, 4 * c)
        return self.reduction(self.norm(x)), (h2, w2)


class PatchEmbed(nn.Module):
    """4x4 stride-4 conv and LayerNorm (flax's 'SAME' padding pads nothing
    at the sizes divisible by 4 that every preset uses)."""

    def __init__(self, embed_dims: int, ln_kernel: bool = True):
        super().__init__()
        self.projection = Conv2d(3, embed_dims, 4, stride=4)
        self.norm = FusedLayerNorm(embed_dims, kernel=ln_kernel)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """(B, 3, H, W) -> normed (B, L, C) tokens and their (h, w)."""
        if x.shape[2] % 4 or x.shape[3] % 4:
            raise ValueError(f"image size {tuple(x.shape[2:])} is not a "
                             f"multiple of 4")
        x = self.projection(x)
        hw = (x.shape[2], x.shape[3])
        return self.norm(x.flatten(2).transpose(1, 2).contiguous()), hw


class SwinStage(nn.Module):
    """``depth`` blocks, alternately unshifted and shifted, with the
    DropPath rates ``drop_paths``; then the PatchMerging, which
    :class:`SwinTransformer` runs."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, downsample: bool, attn_kernel: bool,
                 ln_kernel: bool, drop_paths: Sequence[float], remat: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, shift=d % 2 == 1,
                      attn_kernel=attn_kernel, ln_kernel=ln_kernel,
                      drop_path=drop_paths[d], remat=remat)
            for d in range(depth))
        self.downsample = (PatchMerging(dim, ln_kernel) if downsample
                           else None)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, hw, generator)
        return x


def _nchw(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    return x.reshape(x.shape[0], hw[0], hw[1], -1).permute(0, 3, 1, 2)


class SwinTransformer(nn.Module):
    """Swin backbone: (B, 3, H, W) images -> [stereo feature?] + the
    normed ``out_indices`` stage outputs, NCHW (swin.py:946-971).
    ``out_channels`` lists their channels.  Block i of all ``total`` drops
    its branches at ``drop_path_rate * i / (total - 1)`` in training
    (swin.py:338-339); with ``remat`` a training call recomputes each
    block in the backward."""

    def __init__(self, embed_dims: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 12,
                 out_indices: Sequence[int] = (2, 3),
                 return_stereo_feat: bool = True,
                 attn_kernel: bool = True, ln_kernel: bool = True,
                 drop_path_rate: float = 0.1, remat: bool = False):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.return_stereo_feat = return_stereo_feat
        self.patch_embed = PatchEmbed(embed_dims, ln_kernel)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        starts = np.cumsum((0,) + tuple(depths))
        self.stages = nn.ModuleList(
            SwinStage(embed_dims * 2 ** i, depth, num_heads[i], window_size,
                      downsample=i < len(depths) - 1,
                      attn_kernel=attn_kernel, ln_kernel=ln_kernel,
                      drop_paths=dpr[starts[i]:starts[i + 1]], remat=remat)
            for i, depth in enumerate(depths))
        for i in self.out_indices:
            self.add_module(f"norm{i}", FusedLayerNorm(embed_dims * 2 ** i,
                                                       kernel=ln_kernel))
        self.out_channels = (((embed_dims,) if return_stereo_feat else ())
                             + tuple(embed_dims * 2 ** i
                                     for i in self.out_indices))

    def forward(self, x: torch.Tensor, stage0_only: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """The maps listed in ``out_channels``; with ``stage0_only`` the
        stage-0 feature alone (the stereo extra-reference frame's path).
        ``generator`` draws the DropPath masks in training."""
        x, hw = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.stages):
            x = stage(x, hw, generator)
            out, out_hw = x, hw
            if i == 0 and (self.return_stereo_feat or stage0_only):
                if stage0_only:
                    return _nchw(out, out_hw)
                outs.append(_nchw(out, out_hw))
            if stage.downsample is not None:
                x, hw = stage.downsample(x, hw)
            if i in self.out_indices:
                outs.append(_nchw(getattr(self, f"norm{i}")(out), out_hw))
        return outs
