"""Swin window attention: the hand-written CUDA kernel
``csrc/window_attention.cu`` and its plain PyTorch version.

The kernel replaces both TPU kernels of ``dhd_tpu/ops/window_attention.py``:
``_kernel`` (one (window, head) at a time) and ``_kernel_v2`` (heads
grouped by 128/hd for the TPU's matrix unit).  They compute one function,
per window w and head h of the qkv Linear's output,

    softmax(q k^T * hd^-1/2 + relpos_bias[h] + shift_mask[w % nW_img]) v,

and so does the kernel: q times the scale rounded to the working dtype,
then rounded; fp32 scores; ``e = exp(s - rowmax)``; ``o = sum e_r v`` in
fp32 with ``e_r`` e rounded to the working dtype; ``out = o / sum e``.

The plain version is the JAX package's XLA composition
(``dhd_tpu/nn/swin.py:193-206``) op for op in the working dtype: the
product ``q k^T`` rounded to the dtype, the bias and the mask added in the
dtype, the softmax in fp32 and cast.  In bf16 the two differ by bf16
roundings; the TPU kernel held ≤ 4 bf16 ulp of the output's peak against
that composition, and so must this one.

Bound on an H100: bytes.  Each launch reads qkv once and writes the
output once, W·N·8C bytes in bf16 (DHD-L stage 0: 292 MB, 0.087 ms at
3.35 TB/s); its 4·N²·hd flops per (window, head) are 21 GFLOP at stage 0,
0.021 ms on the tensor cores.  In bf16 the kernel runs both products on
the tensor cores (``mma.sync``) with the scores in registers, a block per
(head, window) pair; in fp32 (the small configurations checked against
the CPU) it runs on the CUDA cores.  Design: see the source.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from dhd_tpu_torch.ops.cuda_build import kernel_op, load

_FN = {torch.bfloat16: "window_attention_bf16",
       torch.float32: "window_attention_f32"}
_HEAD_DIMS = (16, 32)
_MAX_N = 256                    # window 16
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def attention_scale(hd: int, dtype: torch.dtype) -> float:
    """``hd ** -0.5`` rounded to ``dtype``, as JAX rounds the weak-typed
    scalar in ``q * scale`` (0.1767578125 for hd=32 in bf16, not
    0.17677669...)."""
    return float(torch.tensor(hd ** -0.5, dtype=dtype))


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The kernel's C entry for ``dtype``, its ctypes signature set once."""
    fn = getattr(load("window_attention"), _FN[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor], heads: int
                           ) -> torch.Tensor:
    """Plain PyTorch version: the XLA composition of the JAX package, op
    for op in qkv's dtype.  Arguments as :func:`window_attention_cuda`."""
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


def window_attention_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                          mask: Optional[torch.Tensor], heads: int
                          ) -> torch.Tensor:
    """Fused window attention: softmax(q k^T * scale + bias + mask) v.

    Args:
      qkv: (W, N, 3C) output of the qkv Linear, feature order
        [q|k|v] x [head] x [d], bf16 or fp32, contiguous.
      bias: (heads, N, N) relative-position bias in qkv's dtype.
      mask: (nW_img, N, N) additive shift mask in qkv's dtype, window w
        using mask[w % nW_img] (W a multiple of nW_img); None, or a
        (1, N, N) zero mask, for unshifted blocks.
      heads: number of heads; hd = C / heads must be 16 or 32 and N at most
        256 on the GPU.
    Returns:
      (W, N, C) attention output before the projection, qkv's dtype.

    On a CUDA tensor this launches the kernel or raises; a tensor on the
    CPU takes the plain version.  ``window_attention_cuda.launches`` counts
    kernel launches.  A trace (``torch.export``) records the launch as the
    custom op ``dhd_tpu_torch::window_attention``.
    """
    if not qkv.is_cuda:
        if qkv.device.type == "cpu":
            return window_attention_plain(qkv, bias, mask, heads)
        raise ValueError(f"unsupported device {qkv.device}")
    dt = qkv.dtype
    if dt not in _FN:
        raise TypeError(f"window_attention_cuda takes bf16 or fp32, not {dt}")
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv: want (W, N, 3C), got {tuple(qkv.shape)}")
    w, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads if heads > 0 and c % heads == 0 else -1
    if hd not in _HEAD_DIMS or not 0 < n <= _MAX_N:
        raise ValueError(f"unsupported shape: C={c}, heads={heads}, N={n}; "
                         f"want C/heads in {_HEAD_DIMS} and N <= {_MAX_N}")
    n_img = 0 if mask is None else mask.shape[0]
    checks = (("qkv", qkv, (w, n, c3)), ("bias", bias, (heads, n, n)),
              ("mask", mask, (n_img, n, n)))
    for name, t, shape in checks:
        if t is not None and (t.dtype != dt or t.device != qkv.device
                              or t.shape != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: want a contiguous {dt} {shape} on "
                             f"{qkv.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if mask is not None and (n_img == 0 or w % n_img):
        raise ValueError(f"mask: W={w} is not a multiple of nW_img={n_img}")
    if max(qkv.numel(), w * heads) >= 2 ** 31:
        raise ValueError("qkv too large for int32 indices")
    return _window_attention(qkv, bias, mask, heads)


window_attention_cuda.launches = 0


def _launch(qkv: torch.Tensor, bias: torch.Tensor,
            mask: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """The kernel on checked CUDA tensors: the custom op's implementation."""
    if qkv.data_ptr() % 16:     # the bf16 kernel loads 16-byte chunks
        raise ValueError("qkv: want a 16-byte aligned tensor")
    w, n, c3 = qkv.shape
    c, dt = c3 // 3, qkv.dtype
    out = qkv.new_empty((w, n, c))
    if out.numel() == 0:
        return out
    index = qkv.get_device()
    err = _entry(dt)(qkv.data_ptr(), bias.data_ptr(),
                     0 if mask is None else mask.data_ptr(), out.data_ptr(),
                     w, n, c, heads, 0 if mask is None else mask.shape[0],
                     attention_scale(c // heads, dt),
                     torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"window_attention kernel launch failed: CUDA "
                           f"error {err}")
    window_attention_cuda.launches += 1
    return out


_window_attention = kernel_op(
    "window_attention", _launch, lambda qkv, bias, mask, heads:
    qkv.new_empty((qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3)))
