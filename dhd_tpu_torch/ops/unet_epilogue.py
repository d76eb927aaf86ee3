"""A UNet's memory-bound passes between its convolutions (``nn/unet.py``):
the hand-written CUDA kernels ``csrc/unet_epilogue.cu`` and their plain
PyTorch versions, which are the module chain they replace.

* :func:`bn_relu_cuda`: eval ``BatchNorm2d`` then ``ReLU``, written into
  the first channels of a wider buffer (an ``Up``'s concatenation, whose
  first half is the skip) or a tensor of its own, and with ``pool`` also
  the ``nn.MaxPool2d(2)`` of the result, which the next ``Down`` takes.
* :func:`up_place_cuda`: the transposed conv's bias add, ``F.pad`` to the
  skip's size and ``torch.cat``'s copy, into the buffer's last channels.

The kernels replace no TPU kernel: XLA fuses these passes into the JAX
package's convolutions, while PyTorch's eager chain launches each one
(BatchNorm three kernels, ReLU, max pool, bias add, pad, cat).  Their
numbers are the chain's on the card, operation for operation (the source
says how), so they are held to it bit for bit.  cuDNN keeps the
convolutions.

Bound on an H100: bytes.  Each pass reads its input once and writes its
output once, 16 bytes a thread with the channel's scale terms in
registers; at 200x200x64 bf16 that is 10.2 MB (3 us at 3.35 TB/s), and
most of these tensors sit in the 50 MB L2.

Both wrappers take channels-last (NHWC in memory) 4-D tensors whose
channels are a multiple of 8, as the UNet's are (64 to 1024), and count
their launches under :data:`COUNTER`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dhd_tpu_torch import profiling
from dhd_tpu_torch.ops.cuda_build import kernel_op, load

COUNTER = "unet_epilogue_cuda"
_CL = torch.channels_last
_BN_FN = {torch.bfloat16: "unet_bn_relu_bf16",
          torch.float32: "unet_bn_relu_f32"}
_UP_FN = {torch.bfloat16: "unet_up_place_bf16",
          torch.float32: "unet_up_place_f32"}
_BN_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_void_p]
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_UP_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The kernel's C entry ``name``, its ctypes signature set once."""
    fn = getattr(load("unet_epilogue"), name)
    fn.argtypes = _BN_ARGTYPES if name in _BN_FN.values() else _UP_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def bn_relu_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor, eps: float,
                  out: Optional[torch.Tensor] = None, pool: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version: the modules' chain (eval ``BatchNorm2d``,
    ``ReLU``, the concatenation's copy, ``MaxPool2d(2)``).  Arguments and
    returns as :func:`bn_relu_cuda`."""
    y = F.relu(F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps),
               inplace=True)
    pooled = F.max_pool2d(y, 2) if pool else None
    if out is None:
        return y, pooled
    out[:, :y.shape[1]] = y
    return out, pooled


def up_place_plain(up: torch.Tensor, bias: torch.Tensor, out: torch.Tensor
                   ) -> torch.Tensor:
    """Plain PyTorch version: what follows cuDNN's transposed conv in the
    chain (its bias add, ``F.pad`` to ``out``'s size, the concatenation's
    copy into ``out``'s last channels).  Arguments as
    :func:`up_place_cuda`."""
    y = up + bias.view(1, -1, 1, 1)
    dy, dx = out.shape[2] - y.shape[2], out.shape[3] - y.shape[3]
    if dy or dx:
        y = F.pad(y, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    out[:, out.shape[1] - y.shape[1]:] = y
    return out


def _check_nhwc(name: str, t: torch.Tensor, dtype: torch.dtype,
                device: torch.device) -> None:
    if t.dim() != 4 or t.dtype != dtype or t.device != device \
            or not t.is_contiguous(memory_format=_CL):
        raise ValueError(f"{name}: want a channels-last 4-D {dtype} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} "
                         f"{tuple(t.stride())} on {t.device}")
    if t.shape[1] % 8:
        raise ValueError(f"{name}: {t.shape[1]} channels, want a multiple "
                         f"of 8")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} too large for int32 indices")


def bn_relu_cuda(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor, eps: float,
                 out: Optional[torch.Tensor] = None, pool: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Eval BatchNorm, ReLU and optionally the 2x2 max pool in one pass.

    Args:
      x: (N, C, H, W) bf16 or fp32, channels-last, C a multiple of 8.
      mean, var, weight, bias: (C,) fp32, the BatchNorm's running
        statistics and affine; eps its epsilon.
      out: None, or a channels-last (N, C', H, W) buffer of x's type,
        C' >= C, that takes the result in its first C channels.
      pool: also return the ``MaxPool2d(2)`` of the result, (N, C, H // 2,
        W // 2) channels-last.
    Returns:
      (out, or the result where out is None; the pooled tensor or None).

    On a CUDA tensor this launches the kernel or raises; a tensor on the
    CPU takes the plain version.  Launches count under :data:`COUNTER`.  A
    trace (``torch.export``) records the custom op
    ``dhd_tpu_torch::unet_bn_relu``.
    """
    if not x.is_cuda:
        if x.device.type == "cpu":
            return bn_relu_plain(x, mean, var, weight, bias, eps, out, pool)
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _BN_FN:
        raise TypeError(f"bn_relu_cuda takes bf16 or fp32, not {x.dtype}")
    _check_nhwc("x", x, x.dtype, x.device)
    n, c, h, w = x.shape
    for name, t in (("mean", mean), ("var", var), ("weight", weight),
                    ("bias", bias)):
        if t.dtype != torch.float32 or t.device != x.device \
                or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous fp32 ({c},) on "
                             f"{x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if out is None:
        out = torch.empty_like(x, memory_format=_CL)
    else:
        _check_nhwc("out", out, x.dtype, x.device)
        if out.shape[0] != n or out.shape[1] < c \
                or tuple(out.shape[2:]) != (h, w):
            raise ValueError(f"out {tuple(out.shape)}: want ({n}, >= {c}, "
                             f"{h}, {w})")
    pooled = _bn_relu(x, mean, var, weight, bias, eps, out, pool)
    return out, pooled if pool else None


def up_place_cuda(up: torch.Tensor, bias: torch.Tensor, out: torch.Tensor
                  ) -> torch.Tensor:
    """The transposed conv's bias add, its pad and its concatenation in one
    pass: ``out``'s last C channels become ``F.pad(up + bias)`` to its size,
    the pad split as the UNet's odd-size guard splits it (``dy // 2`` rows
    on top, the rest below; the same for the columns).

    Args:
      up: (N, C, h, w) bf16 or fp32 channels-last, the transposed conv's
        output without its bias; C a multiple of 8.
      bias: (C,) in up's type.
      out: a channels-last (N, C', H, W) buffer of up's type, C' >= C,
        H >= h, W >= w: an ``Up``'s concatenation, the skip first.
    Returns:
      out.

    On a CUDA tensor this launches the kernel or raises; a tensor on the
    CPU takes the plain version.  Launches count under :data:`COUNTER`.  A
    trace records the custom op ``dhd_tpu_torch::unet_up_place``.
    """
    if not up.is_cuda:
        if up.device.type == "cpu":
            return up_place_plain(up, bias, out)
        raise ValueError(f"unsupported device {up.device}")
    if up.dtype not in _UP_FN:
        raise TypeError(f"up_place_cuda takes bf16 or fp32, not {up.dtype}")
    _check_nhwc("up", up, up.dtype, up.device)
    _check_nhwc("out", out, up.dtype, up.device)
    n, c, h, w = up.shape
    if bias.dtype != up.dtype or bias.device != up.device \
            or bias.shape != (c,) or not bias.is_contiguous():
        raise ValueError(f"bias: want a contiguous {up.dtype} ({c},) on "
                         f"{up.device}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    if out.shape[0] != n or out.shape[1] < c or out.shape[2] < h \
            or out.shape[3] < w:
        raise ValueError(f"out {tuple(out.shape)}: want ({n}, >= {c}, "
                         f">= {h}, >= {w})")
    _up_place(up, bias, out)
    return out


def _aligned(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: want a 16-byte aligned tensor")


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _launch_bn_relu(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor, eps: float,
                    out: torch.Tensor, pool: bool) -> torch.Tensor:
    """The kernel on checked CUDA tensors: the custom op's implementation.
    Writes ``out``; returns the pooled tensor (empty without ``pool``)."""
    _aligned(x=x, mean=mean, var=var, weight=weight, bias=bias, out=out)
    n, c, h, w = x.shape
    pooled = (torch.empty((n, c, h // 2, w // 2), dtype=x.dtype,
                          device=x.device, memory_format=_CL)
              if pool else x.new_empty(0))
    if x.numel() == 0:
        return pooled
    profiling.mark("unet_bn_relu_kernel")
    err = _entry(_BN_FN[x.dtype])(
        x.data_ptr(), mean.data_ptr(), var.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), eps, out.data_ptr(), out.shape[1],
        pooled.data_ptr() if pool else None, n, h, w, c,
        _stream(x))
    if err != 0:
        raise RuntimeError(f"unet_bn_relu kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count(COUNTER)
    return pooled


def _bn_relu_fake(x, mean, var, weight, bias, eps, out, pool):
    n, c, h, w = x.shape
    if not pool:
        return x.new_empty(0)
    return torch.empty((n, c, h // 2, w // 2), dtype=x.dtype,
                       device=x.device, memory_format=_CL)


def _launch_up_place(up: torch.Tensor, bias: torch.Tensor, out: torch.Tensor
                     ) -> None:
    """The kernel on checked CUDA tensors: the custom op's implementation.
    Writes ``out``."""
    _aligned(up=up, bias=bias, out=out)
    n, c, h, w = up.shape
    big_h, big_w = out.shape[2:]
    if out.numel() == 0:
        return
    profiling.mark("unet_up_place_kernel")
    dy, dx = big_h - h, big_w - w
    skip = out.shape[1] - c          # the channels ahead of up's
    err = _entry(_UP_FN[up.dtype])(
        up.data_ptr(), bias.data_ptr(),
        out.data_ptr() + skip * out.element_size(), out.shape[1], n, big_h,
        big_w, h, w, dy // 2, dx // 2, c, _stream(up))
    if err != 0:
        raise RuntimeError(f"unet_up_place kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count(COUNTER)


_bn_relu = kernel_op("unet_bn_relu", _launch_bn_relu, _bn_relu_fake,
                     mutates_args=("out",))
_up_place = kernel_op("unet_up_place", _launch_up_place,
                      lambda up, bias, out: None, mutates_args=("out",))
