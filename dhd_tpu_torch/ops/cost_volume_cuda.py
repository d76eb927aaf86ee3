"""Stereo matching cost from a warp plan: the hand-written CUDA kernel
``csrc/cost_volume.cu`` and its plain PyTorch version.

The kernel replaces ``dhd_tpu/ops/cost_volume_pallas.py:_kernel``.  For
every camera, depth bin and stereo pixel it samples the previous frame's
features bilinearly at the plan's fractional source coordinates
(zero-padded, ``align_corners=True``), sums ``|curr - warp|`` over the
channels in fp32, and adds ``bias`` where the warped channel 0 is exactly
0.0 (the reference's invalid-sample test, depthnet.py:354-356).  Both
versions upcast bf16 features to fp32 first, so they differ only in the
order of the fp32 channel sum.

Bound on an H100 at DHD-M shapes (6 cameras, 88 bins, 64x176, C=256):
operations, about 11 fp32 flops per sample and channel (16.7 GFLOP,
0.25 ms at 67 TFLOP/s); the bytes (bf16 features, fp32 plan and cost,
140 MB) take 0.04 ms; the time follows each sample's fixed cost.  Design
(see the source): C/8 lanes per pixel in bf16 (C/4 in fp32, at most 32),
so no lane idles at C = 128; a block of 256 threads sweeps the depth bins
in lock-step over a compact tile of pixels with the plan staged in shared
memory; each lane keeps its ``curr`` chunks in registers and has the 16-byte
tap gathers of the next bin in flight while it sums the current one, and
the costs leave as coalesced rows.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dhd_tpu_torch.ops.cuda_build import kernel_op, load

_FN = {torch.bfloat16: "stereo_cost_bf16", torch.float32: "stereo_cost_f32"}
_CHUNK = {torch.bfloat16: 8, torch.float32: 4}   # elements per 16-byte load
_MAX_CHUNKS_PER_LANE = 2   # C <= 512 in bf16, <= 256 in fp32
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The kernel's C entry for ``dtype``, its ctypes signature set once."""
    fn = getattr(load("cost_volume"), _FN[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def cv_cost_plain(prev: torch.Tensor, curr: torch.Tensor, uf: torch.Tensor,
                  vf: torch.Tensor, bias: float = 0.0,
                  depth_chunk: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the kernel, ``depth_chunk`` depth bins at a
    time as the JAX package's scan (unchunked, the fp32 warp at DHD-M would
    take 6.1 GB).  Arguments and result as :func:`stereo_cost_volume_cuda`.
    """
    bn, hs, ws, c = prev.shape
    d = uf.shape[1]
    prev_rows = prev.float().reshape(bn * hs * ws, c)
    curr32 = curr.float()[:, None]                     # (BN, 1, Hs, Ws, C)
    cam = torch.arange(bn, device=prev.device).view(bn, 1, 1, 1) * (hs * ws)

    def axis_weights(i0, frac, size):
        a0 = torch.where((i0 >= 0) & (i0 < size), 1.0 - frac, 0.0)
        a1 = torch.where((i0 + 1 >= 0) & (i0 + 1 < size), frac, 0.0)
        return a0[..., None], a1[..., None]

    def tap(yi, xi):
        rows = cam + yi.clamp(0, hs - 1) * ws + xi.clamp(0, ws - 1)
        return prev_rows[rows.reshape(-1)].reshape(rows.shape + (c,))

    cost = torch.empty((bn, d, hs, ws), dtype=torch.float32,
                       device=prev.device)
    for d0 in range(0, d, depth_chunk):
        u, v = uf[:, d0:d0 + depth_chunk], vf[:, d0:d0 + depth_chunk]
        x0, y0 = torch.floor(u), torch.floor(v)
        ax0, ax1 = axis_weights(x0, u - x0, ws)
        ay0, ay1 = axis_weights(y0, v - y0, hs)
        x0, y0 = x0.long(), y0.long()
        top = tap(y0, x0) * ax0 + tap(y0, x0 + 1) * ax1
        bot = tap(y0 + 1, x0) * ax0 + tap(y0 + 1, x0 + 1) * ax1
        warp = top * ay0 + bot * ay1                   # (BN, k, Hs, Ws, C)
        cst = (curr32 - warp).abs().sum(-1)
        cost[:, d0:d0 + depth_chunk] = torch.where(warp[..., 0] == 0,
                                                   cst + bias, cst)
    return cost


def stereo_cost_volume_cuda(prev: torch.Tensor, curr: torch.Tensor,
                            uf: torch.Tensor, vf: torch.Tensor,
                            bias: float = 0.0) -> torch.Tensor:
    """Raw stereo matching cost.

    Args:
      prev, curr: (BN, Hs, Ws, C) channels-last stereo features of the
        previous and the current frame, bf16 or fp32.
      uf, vf: (BN, D, Hs, Ws) fp32 fractional source column / row of each
        sample in prev (:func:`dhd_tpu_torch.ops.cost_volume.build_cv_plan`).
      bias: added where the warped channel 0 is exactly 0.
    Returns:
      (BN, D, Hs, Ws) fp32 cost.

    On a CUDA tensor this launches the kernel or raises; a tensor on the
    CPU takes the plain version.  ``stereo_cost_volume_cuda.launches``
    counts kernel launches.  A trace (``torch.export``) records the launch
    as the custom op ``dhd_tpu_torch::stereo_cost``.
    """
    if prev.device.type == "cpu":
        return cv_cost_plain(prev, curr, uf, vf, bias)
    if prev.device.type != "cuda":
        raise ValueError(f"unsupported device {prev.device}")
    if prev.dtype not in _FN:
        raise TypeError(f"stereo_cost_volume_cuda takes bf16 or fp32 "
                        f"features, not {prev.dtype}")
    bn, hs, ws, c = prev.shape
    d = uf.shape[1] if uf.dim() == 4 else -1
    for name, t, dtype, shape in (
            ("prev", prev, prev.dtype, (bn, hs, ws, c)),
            ("curr", curr, prev.dtype, (bn, hs, ws, c)),
            ("uf", uf, torch.float32, (bn, d, hs, ws)),
            ("vf", vf, torch.float32, (bn, d, hs, ws))):
        if t.dtype != dtype or t.device != prev.device \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dtype} {shape} "
                             f"on {prev.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    chunk = _CHUNK[prev.dtype]
    if c % chunk or c // chunk > 32 * _MAX_CHUNKS_PER_LANE:
        raise ValueError(f"unsupported C={c} for {prev.dtype}: want a "
                         f"multiple of {chunk}, at most "
                         f"{32 * _MAX_CHUNKS_PER_LANE * chunk}")
    if max(prev.numel(), uf.numel()) >= 2 ** 31:
        raise ValueError("inputs too large for int32 indices")
    return _stereo_cost(prev, curr, uf, vf, float(bias))


stereo_cost_volume_cuda.launches = 0


def _launch(prev: torch.Tensor, curr: torch.Tensor, uf: torch.Tensor,
            vf: torch.Tensor, bias: float) -> torch.Tensor:
    """The kernel on checked CUDA tensors: the custom op's implementation."""
    for name, t in (("prev", prev), ("curr", curr), ("uf", uf), ("vf", vf)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: want a 16-byte aligned tensor")
    bn, hs, ws, c = prev.shape
    d = uf.shape[1]
    cost = torch.empty((bn, d, hs, ws), dtype=torch.float32,
                       device=prev.device)
    if cost.numel() == 0:
        return cost
    err = _entry(prev.dtype)(
        prev.data_ptr(), curr.data_ptr(), uf.data_ptr(), vf.data_ptr(),
        cost.data_ptr(), bn, d, hs, ws, c, bias,
        torch._C._cuda_getCurrentRawStream(prev.get_device()))
    if err != 0:
        raise RuntimeError(
            f"cost_volume kernel launch failed: CUDA error {err}")
    stereo_cost_volume_cuda.launches += 1
    return cost


_stereo_cost = kernel_op(
    "stereo_cost", _launch, lambda prev, curr, uf, vf, bias: prev.new_empty(
        (prev.shape[0], uf.shape[1]) + prev.shape[1:3], dtype=torch.float32))
