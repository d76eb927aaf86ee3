"""Segment-sum over points sorted by segment id: the hand-written CUDA
kernel ``csrc/segment_sum.cu`` (kernel B2), its plain PyTorch version, and
the unsorted entry :func:`segment_sum_pooling` with its gradient.
Counterpart of ``dhd_tpu/ops/pallas_pool.py:107-217``.

The kernel replaces ``dhd_tpu/ops/pallas_pool.py:_kernel``: ``out[v]`` is
the fp32 sum of the rows whose id is ``v``, for ``v`` in [0, V); rows whose
id is negative or at least V are dropped.  The TPU entry points' tiling
knobs (``interpret``, ``block_v``, ``chunk_p``) have no counterpart.

Bound on an H100 at the DHD-S ``--what pool`` shapes (P = 185,856 rows of
C = 64 bf16, V = 640,000): bytes, 23.8 MB of rows, 0.7 MB of ids and the
81.9 MB output, 0.032 ms at 3.35 TB/s.  Design (see the source): the
points and the segment ends are split merge-path style, so every warp takes
an equal share of (points + segments) whatever the ids' skew, and a share
boundary inside a segment moves to the segment's end when that is near, so
only long segments cross shares; a warp sums its points in registers with
its lanes across the channels and writes each segment that lies wholly in
its share once, and a second pass adds the fp32 partial rows of the
segments that cross shares, in share order: no atomics, no zero-fill pass,
the same sums on every run.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from dhd_tpu_torch import profiling
from dhd_tpu_torch.ops.cuda_build import load

_NAME = {torch.bfloat16: "bf16", torch.float32: "f32"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _entry(in_dtype: torch.dtype, out_dtype: torch.dtype):
    """The kernel's C entry for the dtypes, its ctypes signature set once."""
    fn = getattr(load("segment_sum"),
                 f"segment_sum_{_NAME[in_dtype]}_{_NAME[out_dtype]}")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _items() -> int:
    """Points + segment ends per warp's share of the merge."""
    return int(load("segment_sum").segment_sum_items())


def channels_per_lane(vals: torch.Tensor) -> int:
    """The kernel's channels per lane for (P, C) ``vals``: the fewest
    passes over the channels (32 lanes of that many each), up to 4 channels
    a lane in accesses that keep the rows' alignment."""
    c, esz = vals.shape[-1], vals.element_size()
    vec = 1
    while c > 32 * vec and vec < 4 and c % (2 * vec) == 0 \
            and vals.data_ptr() % (2 * vec * esz) == 0:
        vec *= 2
    return vec


def sorted_segment_sum_plain(vals: torch.Tensor, seg_sorted: torch.Tensor,
                             num_segments: int,
                             out_dtype: torch.dtype = torch.float32,
                             order: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: an ``index_add_`` into an fp32
    (V + 1, C) buffer whose spare row takes the dropped ids.  Arguments as
    :func:`sorted_segment_sum` (the order of the ids does not matter
    here)."""
    if order is not None:
        vals = vals[order.long()]
    seg = seg_sorted.long()
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out = torch.zeros((num_segments + 1, vals.shape[-1]), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, seg, vals.float())
    return out[:num_segments].to(out_dtype)


def sorted_segment_sum(vals: torch.Tensor, seg_sorted: torch.Tensor,
                       num_segments: int,
                       out_dtype: torch.dtype = torch.float32,
                       order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment-sum over rows sorted by segment id.

    Args:
      vals: (P, C) bf16 or fp32 values: row i has id ``seg_sorted[i]``, or,
        with ``order``, row ``order[i]`` has it (the kernel gathers the rows
        of unsorted values itself).
      seg_sorted: (P,) int32, non-decreasing.
      num_segments: V; ids outside [0, V) are dropped.
      out_dtype: bf16 or fp32 (the sums are fp32 either way).
      order: optional (P,) int32 row of each sorted id.
    Returns:
      (V, C) sums in ``out_dtype``; empty segments are exactly zero.

    On a CUDA tensor this launches the kernel or raises; a tensor on the
    CPU takes the plain version.  ``profiling.kernel_launches()`` counts its
    kernel launches.
    """
    if vals.device.type == "cpu":
        return sorted_segment_sum_plain(vals, seg_sorted, num_segments,
                                        out_dtype, order)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    if vals.dtype not in _NAME or out_dtype not in _NAME:
        raise TypeError(f"sorted_segment_sum takes and gives bf16 or fp32, "
                        f"not {vals.dtype} -> {out_dtype}")
    if vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError(f"vals: want a contiguous (P, C) tensor, got "
                         f"{tuple(vals.shape)}")
    p_rows, c = vals.shape
    p = seg_sorted.numel()
    idx = [("seg_sorted", seg_sorted)] + (
        [("order", order)] if order is not None else [])
    for name, t in idx:
        if t.dtype != torch.int32 or t.device != vals.device \
                or t.dim() != 1 or t.numel() != p or not t.is_contiguous():
            raise ValueError(f"{name}: want {p} contiguous int32 on "
                             f"{vals.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if order is None and p_rows != p:
        raise ValueError(f"vals has {p_rows} rows for {p} ids")
    if c < 1 or num_segments < 0:
        raise ValueError(f"unsupported C={c}, V={num_segments}")
    if max(p_rows * c, num_segments * c, p + num_segments) >= 2 ** 31:
        raise ValueError("inputs too large for int32 indices")
    out = torch.empty((num_segments, c), dtype=out_dtype, device=vals.device)
    if out.numel() == 0:
        return out
    vec = channels_per_lane(vals)
    # per share: a carry and a head row of C fp32, and their two row ids
    shares = -(-(p + num_segments) // _items())
    scratch = torch.empty(shares * (2 * c + 2), dtype=torch.float32,
                          device=vals.device)
    profiling.mark("segment_sum_share_kernel")
    err = _entry(vals.dtype, out_dtype)(
        vals.data_ptr(), seg_sorted.data_ptr(),
        order.data_ptr() if order is not None else None, out.data_ptr(),
        scratch.data_ptr(), p, c, num_segments, vec,
        torch._C._cuda_getCurrentRawStream(vals.get_device()))
    if err != 0:
        raise RuntimeError(
            f"segment_sum kernel launch failed: CUDA error {err}")
    profiling.count("sorted_segment_sum")
    return out



class _SegmentSumPooling(torch.autograd.Function):
    """Forward: sort the ids, then the sorted segment-sum with the kernel
    gathering the rows in sorted order.  Backward (``pallas_pool.py:208-
    214``): the transpose of a segment-sum is a gather of the output
    gradient, zero for dropped ids."""

    @staticmethod
    def forward(ctx, vals, seg, num_segments):
        seg_s, order = torch.sort(seg, stable=True)
        ctx.save_for_backward(seg)
        ctx.num_segments = num_segments
        return sorted_segment_sum(vals, seg_s, num_segments,
                                  out_dtype=vals.dtype,
                                  order=order.to(torch.int32))

    @staticmethod
    def backward(ctx, grad):
        seg, = ctx.saved_tensors
        v = ctx.num_segments
        keep = ((seg >= 0) & (seg < v))[:, None]
        dvals = grad[seg.clamp(0, max(v - 1, 0)).long()]
        return torch.where(keep, dvals, 0).to(grad.dtype), None, None


def segment_sum_pooling(vals: torch.Tensor, seg: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Segment-sum of unsorted (P, C) ``vals`` by their (P,) ids ``seg``
    into (V, C) in ``vals.dtype`` (fp32 sums); ids outside [0, V) are
    dropped.  Differentiable in ``vals``.  On a CUDA tensor the sum is
    kernel B2 (:func:`sorted_segment_sum`)."""
    if seg.dtype != torch.int32:
        # ids beyond int32 are out of range either way
        seg = seg.clamp(-1, num_segments).to(torch.int32)
    return _SegmentSumPooling.apply(vals.contiguous(), seg.contiguous(),
                                    num_segments)
