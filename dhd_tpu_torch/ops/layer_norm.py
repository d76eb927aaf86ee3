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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dhd_tpu_torch import profiling
from dhd_tpu_torch.ops.cuda_build import kernel_op, load

_FN = {torch.bfloat16: "layer_norm_bf16", torch.float32: "layer_norm_f32"}
_MAX_C = 2048
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The kernel's C entry for ``dtype``, its ctypes signature set once."""
    fn = getattr(load("layer_norm"), _FN[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


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
    if not x.is_cuda:
        if x.device.type == "cpu":
            return layer_norm_plain(x, weight, bias, eps)
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _FN:
        raise TypeError(f"fused_layer_norm_cuda takes bf16 or fp32, not "
                        f"{x.dtype}")
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
    return _layer_norm(x, weight, bias, eps)



def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """The kernel on checked CUDA tensors: the custom op's implementation."""
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: want a 16-byte aligned tensor")
    out = torch.empty_like(x)
    n, c = x.numel(), x.shape[-1]
    if n == 0:
        return out
    profiling.mark("layer_norm_kernel")
    err = _entry(x.dtype)(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                          out.data_ptr(), n // c, c, eps,
                          torch._C._cuda_getCurrentRawStream(
                              x.get_device()))
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("fused_layer_norm_cuda")
    return out


_layer_norm = kernel_op("layer_norm", _launch,
                        lambda x, weight, bias, eps: torch.empty_like(x))
