"""One-pass LayerNorm over the last axis: the hand-written CUDA kernel
``csrc/layer_norm.cu`` and its plain PyTorch version.

The kernel replaces ``dhd_tpu/ops/layer_norm.py:_ln_kernel``.  Both
versions compute what the JAX package's ``FusedLayerNorm`` computes
(``dhd_tpu/nn/swin.py:126-131``): fp32 statistics with the one-pass
variance ``max(E[x^2] - E[x]^2, 0)``, ``mul = rsqrt(var + eps) * weight``,
``y = (x - mean) * mul + bias`` in fp32, cast to x's dtype; fp32 weight and
bias; eps 1e-6.  This is not ``F.layer_norm`` (two-pass variance) and not
eps 1e-5.  The two differ only in the order of the fp32 row sums.

Bound on an H100: bytes.  A Swin-B LayerNorm reads and writes its rows
once in bf16 (a DHD-L stage-2 block LN, 16,896 x 512, moves 34.6 MB:
0.010 ms at 3.35 TB/s); its ~8 flops per element are far below the
compute roof.  Design (see the source): persistent blocks walk the rows,
each lane holding one 16-byte chunk of a row (C/8 lanes per row in bf16)
and its weight and bias in registers for the whole walk, the next row's
chunk loaded while the current row is reduced.

Two more instantiations of the same kernel carry a Swin block's data
movement, so that a block (``nn/swin.py:SwinBlock``) launches them in place
of its pad, window partition, window reverse, attention residual and
LayerNorms: :func:`swin_window_norm_cuda` (norm1 written in window order,
zeros where the window covers padding) and :func:`swin_residual_norm_cuda`
(the window reverse, the residual add and norm2).  Their row maps are
:func:`window_rows` and :func:`residual_rows`, computed per row in the
kernel with the same arithmetic.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from dhd_tpu_torch import profiling
from dhd_tpu_torch.ops.cuda_build import kernel_op, load

_FN = {torch.bfloat16: "layer_norm_bf16", torch.float32: "layer_norm_f32"}
_WINDOW_FN = {torch.bfloat16: "layer_norm_windows_bf16",
              torch.float32: "layer_norm_windows_f32"}
_RESIDUAL_FN = {torch.bfloat16: "layer_norm_residual_bf16",
                torch.float32: "layer_norm_residual_f32"}
_MAX_C = 2048
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_void_p])
_WINDOW_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                    + [ctypes.c_float] + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])
_RESIDUAL_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                      + [ctypes.c_float] + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The kernel's C entry ``name``, its ctypes signature set once."""
    fn = getattr(load("layer_norm"), name)
    fn.argtypes = (_WINDOW_ARGTYPES if name in _WINDOW_FN.values()
                   else _RESIDUAL_ARGTYPES if name in _RESIDUAL_FN.values()
                   else _ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def _divider(d: int) -> Tuple[int, int]:
    """``(m, s)`` with ``n // d == ((n * m >> 32) + n) >> s`` for every
    ``0 <= n < 2**31``: the kernel's division by a multiply and a shift
    (``csrc/layer_norm.cu:make_div``)."""
    s = 0
    while (1 << s) < d:
        s += 1
    return ((1 << 32) * ((1 << s) - d)) // d + 1, s


def _div(n: np.ndarray, d: int) -> np.ndarray:
    """``n // d`` as the kernel computes it (``Div::div``)."""
    m, s = _divider(d)
    n = n.astype(np.int64)
    return (((n * m) >> 32) + n) >> s


def padded(h: int, w: int, ws: int) -> Tuple[int, int]:
    """The (h, w) map padded below and right to multiples of ``ws``."""
    return -(-h // ws) * ws, -(-w // ws) * ws


@functools.lru_cache(maxsize=None)
def window_rows(images: int, h: int, w: int, ws: int, shift: int
                ) -> np.ndarray:
    """For each row of the window tensor of ``images`` (h, w) token maps,
    padded to multiples of ``ws``, cyclically shifted by ``shift`` and
    partitioned into ws x ws windows: the token row of x it holds, or -1
    where it holds padding.  The arithmetic of the kernel's
    ``window_source``, row by row."""
    hp, wp = padded(h, w, ws)
    nw_w, n_win = wp // ws, ws * ws
    r = np.arange(images * hp * wp, dtype=np.int64)
    b = _div(r, hp * wp)
    q = r - b * hp * wp
    widx = _div(q, n_win)
    n = q - widx * n_win
    wi = _div(widx, nw_w)
    wj = widx - wi * nw_w
    pi = _div(n, ws)
    pj = n - pi * ws
    si = wi * ws + pi + shift
    sj = wj * ws + pj + shift
    si = np.where(si >= hp, si - hp, si)
    sj = np.where(sj >= wp, sj - wp, sj)
    return np.where((si < h) & (sj < w), (b * h + si) * w + sj, -1)


@functools.lru_cache(maxsize=None)
def residual_rows(images: int, h: int, w: int, ws: int, shift: int
                  ) -> np.ndarray:
    """For each token row of ``images`` (h, w) maps: the row of the window
    tensor (as :func:`window_rows` lays it out) that window reverse, the
    unshift and the crop bring back there.  The arithmetic of the
    kernel's ``window_target``, row by row."""
    hp, wp = padded(h, w, ws)
    nw_w, n_win = wp // ws, ws * ws
    t = np.arange(images * h * w, dtype=np.int64)
    b = _div(t, h * w)
    k = t - b * h * w
    i = _div(k, w)
    j = k - i * w
    ri = i - shift
    rj = j - shift
    ri = np.where(ri < 0, ri + hp, ri)
    rj = np.where(rj < 0, rj + wp, rj)
    wi = _div(ri, ws)
    wj = _div(rj, ws)
    return (b * hp * wp + (wi * nw_w + wj) * n_win + (ri - wi * ws) * ws
            + (rj - wj * ws))


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: the JAX package's one-pass formula op for op
    in fp32, cast to x's dtype.  Arguments as :func:`fused_layer_norm_cuda`.
    """
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()
    return y.to(x.dtype)


def window_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float, hw: Tuple[int, int],
                      ws: int, shift: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`swin_window_norm_cuda`: the
    LayerNorm of x's rows gathered by :func:`window_rows`, zeros where a
    window holds padding.  Arguments as the wrapper's."""
    y = layer_norm_plain(x, weight, bias, eps)
    src = torch.from_numpy(window_rows(x.shape[0], *hw, ws, shift)).to(
        x.device)
    out = y.new_zeros((src.numel(), x.shape[-1]))
    live = src >= 0
    out[live] = y.reshape(-1, x.shape[-1])[src[live]]
    return out


def residual_norm_plain(x: torch.Tensor, wins: torch.Tensor,
                        weight: torch.Tensor, bias: torch.Tensor, eps: float,
                        hw: Tuple[int, int], ws: int, shift: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`swin_residual_norm_cuda`: x plus
    the window rows that :func:`residual_rows` brings back, and the
    LayerNorm of that sum.  Arguments and returns as the wrapper's."""
    rows = torch.from_numpy(residual_rows(x.shape[0], *hw, ws, shift)).to(
        x.device)
    s = x + wins.reshape(-1, x.shape[-1])[rows].reshape(x.shape)
    return s, layer_norm_plain(s, weight, bias, eps)


def _check(fn: str, x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> None:
    """Raise unless the kernel ``fn`` takes x (a contiguous bf16 or fp32
    tensor of C channels, C a multiple of 8 and at most 2048, under 2^31
    elements) and the fp32 (C,) affines on x's device."""
    if x.dtype not in _FN:
        raise TypeError(f"{fn} takes bf16 or fp32, not {x.dtype}")
    c = x.shape[-1]
    if c % 8 or not 0 < c <= _MAX_C:
        raise ValueError(f"unsupported C={c}: want a multiple of 8, at most "
                         f"{_MAX_C}")
    if not x.is_contiguous():
        raise ValueError("x: want a contiguous tensor")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != x.device \
                or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous fp32 ({c},) on "
                             f"{x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if x.numel() >= 2 ** 31:
        raise ValueError("x too large for int32 indices")


def _on_card(x: torch.Tensor) -> bool:
    """Whether x takes the kernel: True on CUDA, False on the CPU (the
    plain version); raises on any other device."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


def _window_args(x: torch.Tensor, hw: Tuple[int, int], ws: int,
                 shift: int) -> int:
    """Raise unless x holds (B, h * w, C) tokens and the windows of ws x ws
    shifted by ``shift`` (0 <= shift < ws) fit int32 rows; returns the
    window tensor's rows."""
    h, w = hw
    if x.dim() != 3 or x.shape[1] != h * w or min(h, w) <= 0:
        raise ValueError(f"x: want (B, {h} * {w}, C) tokens, got "
                         f"{tuple(x.shape)}")
    if not 0 <= shift < ws:
        raise ValueError(f"unsupported shift {shift} for window {ws}")
    hp, wp = padded(h, w, ws)
    rows = x.shape[0] * hp * wp
    if rows * x.shape[-1] >= 2 ** 31:
        raise ValueError("windows too large for int32 indices")
    return rows


def fused_layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-6
                          ) -> torch.Tensor:
    """LayerNorm over the last axis in one pass.

    Args:
      x: (..., C) bf16 or fp32, contiguous; on the GPU C is a multiple of 8
        and at most 2048 (every C the presets reach).
      weight, bias: (C,) fp32 affine parameters.
    Returns:
      (..., C) in x.dtype.

    On a CUDA tensor this launches the kernel or raises; a tensor on the
    CPU takes the plain version.  ``profiling.kernel_launches()`` counts its
    kernel launches.  A trace (``torch.export``) records the launch as the
    custom op ``dhd_tpu_torch::layer_norm``, which an exported program
    runs on the card.
    """
    if not _on_card(x):
        return layer_norm_plain(x, weight, bias, eps)
    _check("fused_layer_norm_cuda", x, weight, bias)
    return _layer_norm(x, weight, bias, eps)


def swin_window_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, eps: float,
                          hw: Tuple[int, int], ws: int, shift: int
                          ) -> torch.Tensor:
    """A Swin block's norm1, written in window order: the chain
    LayerNorm, ``F.pad`` to multiples of ``ws``, the cyclic shift and the
    window partition, in one launch of the LayerNorm kernel.

    Args:
      x: (B, h * w, C) tokens of B (h, w) maps, as
        :func:`fused_layer_norm_cuda` takes them.
      weight, bias: norm1's (C,) fp32 affines; eps its epsilon.
      hw: (h, w); ws: the window; shift: the cyclic shift (0 unshifted).
    Returns:
      (B * nW * ws * ws, C) in x.dtype, window-major: row r is the norm of
      token ``window_rows(B, h, w, ws, shift)[r]``, or zeros where that is
      -1 (padding, which the chain pads after the norm).

    On a CUDA tensor it launches the kernel or raises; on the CPU it takes
    :func:`window_norm_plain`.  Launches count under this function's name
    in ``profiling.kernel_launches()``; a trace records the custom op
    ``dhd_tpu_torch::swin_window_norm``.
    """
    if not _on_card(x):
        return window_norm_plain(x, weight, bias, eps, hw, ws, shift)
    _check("swin_window_norm_cuda", x, weight, bias)
    _window_args(x, hw, ws, shift)
    return _window_norm(x, weight, bias, eps, hw[0], hw[1], ws, shift)


def swin_residual_norm_cuda(x: torch.Tensor, wins: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor,
                            eps: float, hw: Tuple[int, int], ws: int,
                            shift: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Swin block's window reverse, attention residual and norm2: the
    chain of the window reverse with the unshift and the crop (a row
    gather), ``x + attn`` and the LayerNorm, in one launch of the
    LayerNorm kernel.

    Args:
      x: (B, h * w, C) the block's input tokens.
      wins: the attention's output in window order (B * nW * ws * ws rows
        of C, contiguous, x's dtype and device), as
        :func:`swin_window_norm_cuda` lays its rows out.
      weight, bias: norm2's (C,) fp32 affines; eps its epsilon.
      hw, ws, shift: as :func:`swin_window_norm_cuda`.
    Returns:
      ``(s, y)``, both (B, h * w, C) in x.dtype: ``s = x + wins[rows]``
      with ``rows = residual_rows(B, h, w, ws, shift)``, the add in fp32
      rounded to x.dtype as PyTorch's add, and ``y`` the LayerNorm of s.

    Devices, counter and custom op (``dhd_tpu_torch::swin_residual_norm``)
    as :func:`swin_window_norm_cuda`.
    """
    if not _on_card(x):
        return residual_norm_plain(x, wins, weight, bias, eps, hw, ws, shift)
    _check("swin_residual_norm_cuda", x, weight, bias)
    rows = _window_args(x, hw, ws, shift)
    if wins.dtype != x.dtype or wins.device != x.device \
            or wins.numel() != rows * x.shape[-1] or not wins.is_contiguous():
        raise ValueError(f"wins: want {rows} contiguous rows of "
                         f"{x.shape[-1]} in {x.dtype} on {x.device}, got "
                         f"{wins.dtype} {tuple(wins.shape)} on "
                         f"{wins.device}")
    return _residual_norm(x, wins, weight, bias, eps, hw[0], hw[1], ws,
                          shift)


def _aligned(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: want a 16-byte aligned tensor")


def _stream(x: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """The kernel on checked CUDA tensors: the custom op's implementation."""
    _aligned(x=x, weight=weight, bias=bias)
    out = torch.empty_like(x)
    n, c = x.numel(), x.shape[-1]
    if n == 0:
        return out
    profiling.mark("layer_norm_kernel")
    _raise_on(_entry(_FN[x.dtype])(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        n // c, c, eps, _stream(x)), "layer_norm")
    profiling.count("fused_layer_norm_cuda")
    return out


def _window_shape(x: torch.Tensor, h: int, w: int, ws: int
                  ) -> Tuple[int, int]:
    hp, wp = padded(h, w, ws)
    return x.shape[0] * hp * wp, x.shape[-1]


def _launch_window(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float, h: int, w: int, ws: int, shift: int
                   ) -> torch.Tensor:
    """:func:`swin_window_norm_cuda`'s kernel on checked CUDA tensors."""
    _aligned(x=x, weight=weight, bias=bias)
    out = x.new_empty(_window_shape(x, h, w, ws))
    if x.numel() == 0:
        return out
    profiling.mark("layer_norm_kernel")
    _raise_on(_entry(_WINDOW_FN[x.dtype])(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        x.shape[0], x.shape[-1], eps, h, w, ws, shift, _stream(x)),
        "swin_window_norm")
    profiling.count("swin_window_norm_cuda")
    return out


def _launch_residual(x: torch.Tensor, wins: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor, eps: float,
                     h: int, w: int, ws: int, shift: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`swin_residual_norm_cuda`'s kernel on checked CUDA tensors."""
    _aligned(x=x, wins=wins, weight=weight, bias=bias)
    s, y = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return s, y
    profiling.mark("layer_norm_kernel")
    _raise_on(_entry(_RESIDUAL_FN[x.dtype])(
        x.data_ptr(), wins.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        s.data_ptr(), y.data_ptr(), x.shape[0], x.shape[-1], eps, h, w, ws,
        shift, _stream(x)), "swin_residual_norm")
    profiling.count("swin_residual_norm_cuda")
    return s, y


_layer_norm = kernel_op("layer_norm", _launch,
                        lambda x, weight, bias, eps: torch.empty_like(x))
_window_norm = kernel_op(
    "swin_window_norm", _launch_window,
    lambda x, weight, bias, eps, h, w, ws, shift: x.new_empty(
        _window_shape(x, h, w, ws)))
_residual_norm = kernel_op(
    "swin_residual_norm", _launch_residual,
    lambda x, wins, weight, bias, eps, h, w, ws, shift: (
        torch.empty_like(x), torch.empty_like(x)))
