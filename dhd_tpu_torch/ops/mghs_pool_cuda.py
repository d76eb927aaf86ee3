"""Fused MGHS pooling over a :class:`PoolPlan`: the hand-written CUDA kernel
``csrc/mghs_pool.cu`` and its plain PyTorch version.

The kernel replaces ``dhd_tpu/ops/pallas_pool.py:_kernel_dual_fused``.  Over
the points sorted by z-minor voxel key it takes the depth at the point's
bin, ``v = d * feat`` (rounded to the working dtype), adds ``v`` to
``vox[pillar * Dz + z]`` where the point's height-band gate is on, and adds
``v`` ungated to ``bev[pillar]``, summing in fp32.

Bound on an H100 at DHD-S shapes: bytes.  Writing ``vox`` (640,000 x 64
bf16 = 81.9 MB) and ``bev`` (5.1 MB) dominates; the sorted point indices add
about 1.5 MB and the per-pixel tables (4,224 rows) stay in L2: about 27 us at
3.35 TB/s.  Design (see the source): a warp per task of the plan's schedule
(:func:`pool_schedule_plain`; on the card :func:`pool_plan_cuda` builds
it with the rest of the plan, three small kernels of the same source), a
pillar or a piece of at most 128 points of a longer one, the heaviest first; a point's
row lies across a group of lanes (:func:`lanes_per_point`), so a warp sums
several points a step; the bev and current vox row sums stay in registers
and each row is stored once, zeros included, as z moves on; the pieces of
a split pillar leave fp32 partial blocks that a second pass adds in order.
No atomics, no zero-fill pass, the same sums on every run.

:func:`mghs_pool_cuda` is differentiable in ``depth`` and ``feat``
(:class:`_MGHSPool`): the backward mirrors the JAX package's
``_dual_fused_bwd`` (``dhd_tpu/ops/pallas_pool.py:410-442``) in torch ops.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from dhd_tpu_torch import profiling
from dhd_tpu_torch.ops.cuda_build import kernel_op, load
from dhd_tpu_torch.ops.grad_mode import records_grad
from dhd_tpu_torch.ops.voxel_pool import PoolPlan, sorted_tables

_FN = {torch.bfloat16: "mghs_pool_bf16", torch.float32: "mghs_pool_f32"}
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_PLAN_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                  + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_void_p])

# the most points one warp of the pooling kernel sums: a longer pillar is
# split over several warps (:func:`pool_schedule_plain`)
POOL_PIECE = 128
_MAX_PIECE = 256                    # csrc/mghs_pool.cu kMaxPiece
_PLAN_TILE = 1024                   # csrc/mghs_pool.cu kPlanTile: pillars
#                                     a block of the plan's counts


def lanes_per_point(feat: torch.Tensor) -> Tuple[int, int]:
    """The kernel's (channels a lane, lanes a point) for ``feat``'s rows:
    the widest of 4, 2, 1 channels that divides C and keeps the rows'
    alignment, and the fewest of 8, 16, 32 lanes that hold a row (32 then
    take C in several passes): a warp sums 32 / lanes points a step."""
    c, esz = feat.shape[-1], feat.element_size()
    vec = 4
    while vec > 1 and (c % vec or feat.data_ptr() % (vec * esz)):
        vec //= 2
    lanes = 8
    while lanes < 32 and lanes * vec < c:
        lanes *= 2
    return vec, lanes


def _schedule_sizes(n_pillars: int, n_points: int, piece: int
                    ) -> Tuple[int, int, int]:
    """(tasks, split entries, scratch slots) of a schedule, from the shapes
    alone: a pillar of n points takes max(1, ceil(n / piece)) tasks, and a
    split pillar (n > piece) ceil(n / piece) <= 2 * floor(n / piece)
    slots."""
    return (n_pillars + n_points // piece,
            min(n_pillars, n_points // (piece + 1)), 2 * (n_points // piece))


def pool_plan_cuda(key_s: torch.Tensor, order: torch.Tensor,
                   seg_vox: torch.Tensor, num_seg_vox: int,
                   cams_shape: Tuple[int, int, int, int, int], dz: int,
                   piece: int = POOL_PIECE) -> Tuple:
    """The plan's tensors from the points sorted by key, the kernel's
    schedule included (:func:`pool_schedule_plain` says what it holds).

    Args:
      key_s: (P,) int32 sorted keys (``torch.sort(idx.key, stable=True)``).
      order: (P,) int64 the sort's indices.
      seg_vox: (P,) int32 :attr:`PoolIndices.seg_vox`.
      num_seg_vox, cams_shape, dz: as :func:`build_pool_plan` has them.
    Returns:
      dix_s, z_s, starts, tasks, splits, n_slots: :class:`PoolPlan`'s.

    On a CUDA tensor this launches the plan kernels of
    ``csrc/mghs_pool.cu`` (three launches, one host call) or raises; a
    tensor on the CPU takes :func:`pool_plan_plain`.  Nothing is read back
    to the host, so a frame that plans in the call does not wait.
    ``profiling.kernel_launches()`` counts its host calls.  A trace
    (``torch.export``) records the call as the custom op
    ``dhd_tpu_torch::pool_plan``.
    """
    if key_s.device.type == "cpu":
        return pool_plan_plain(key_s, order, seg_vox, num_seg_vox,
                               cams_shape, dz, piece)
    if key_s.device.type != "cuda":
        raise ValueError(f"unsupported device {key_s.device}")
    if not 1 <= piece <= _MAX_PIECE:
        raise ValueError(f"piece={piece}: want 1..{_MAX_PIECE}")
    p = key_s.numel()
    for name, t, dtype in (("key_s", key_s, torch.int32),
                           ("order", order, torch.int64),
                           ("seg_vox", seg_vox, torch.int32)):
        if t.dtype != dtype or t.shape != (p,) or not t.is_contiguous() \
                or t.device != key_s.device:
            raise ValueError(f"{name}: want a contiguous {dtype} ({p},) on "
                             f"{key_s.device}")
    _, _, d, fh, fw = cams_shape
    n_pillars = num_seg_vox // dz
    if p < 1 or n_pillars < 1 or p * d >= 2 ** 31:
        raise ValueError(f"unsupported P={p}, {n_pillars} pillars")
    out = _pool_plan(key_s, order, seg_vox, num_seg_vox, d, fh * fw, dz,
                     piece)
    n_tasks, n_splits, n_slots = _schedule_sizes(n_pillars, p, piece)
    tasks, splits, dix_s, z_s, starts, _ = out.split(
        _plan_parts(n_pillars, p, piece))
    return (dix_s, z_s, starts, tasks.view(n_tasks, 4),
            splits.view(n_splits, 4), n_slots)


def _plan_parts(n_pillars: int, p: int, piece: int) -> list:
    """The sizes of the plan's one int32 allocation, the 16-byte rows
    first: tasks, splits, dix_s, z_s, starts and the kernels' counts."""
    n_tasks, n_splits, _ = _schedule_sizes(n_pillars, p, piece)
    n_tiles = -(-n_pillars // _PLAN_TILE)
    return [4 * n_tasks, 4 * n_splits, p, p, n_pillars + 1,
            n_tiles * (piece + 3)]


def _plan_launch(key_s: torch.Tensor, order: torch.Tensor,
                 seg_vox: torch.Tensor, num_seg_vox: int, d: int, hw: int,
                 dz: int, piece: int) -> torch.Tensor:
    """The plan kernels on checked CUDA tensors, into one int32 buffer
    (:func:`_plan_parts`): the custom op's implementation."""
    p, n_pillars = key_s.numel(), num_seg_vox // dz
    parts = _plan_parts(n_pillars, p, piece)
    out = torch.empty(sum(parts), dtype=torch.int32, device=key_s.device)
    tasks, splits, dix_s, z_s, starts, counts = out.split(parts)
    profiling.mark("plan_points_kernel")
    err = _entry("plan")(
        key_s.data_ptr(), order.data_ptr(), seg_vox.data_ptr(), p, n_pillars,
        dz, num_seg_vox, d, hw, piece, dix_s.data_ptr(), z_s.data_ptr(),
        starts.data_ptr(), tasks.data_ptr(), parts[0] // 4,
        splits.data_ptr(), parts[1] // 4, counts.data_ptr(),
        torch._C._cuda_getCurrentRawStream(key_s.get_device()))
    if err != 0:
        raise RuntimeError(f"mghs_pool plan launch failed: CUDA error {err}")
    profiling.count("pool_plan_cuda")
    return out


_pool_plan = kernel_op(
    "pool_plan", _plan_launch,
    lambda key_s, order, seg_vox, num_seg_vox, d, hw, dz, piece:
    key_s.new_empty((sum(_plan_parts(num_seg_vox // dz, key_s.numel(),
                                     piece)),), dtype=torch.int32))



def pool_plan_plain(key_s: torch.Tensor, order: torch.Tensor,
                    seg_vox: torch.Tensor, num_seg_vox: int,
                    cams_shape: Tuple[int, int, int, int, int], dz: int,
                    piece: int = POOL_PIECE) -> Tuple:
    """Plain PyTorch version of :func:`pool_plan_cuda`: the CPU plan's
    tables (:func:`~dhd_tpu_torch.ops.voxel_pool.sorted_tables`) and
    :func:`pool_schedule_plain`."""
    dix_s, z_s, starts = sorted_tables(key_s, order, seg_vox, num_seg_vox,
                                       cams_shape, dz)
    return (dix_s, z_s, starts) + pool_schedule_plain(starts, key_s.numel(),
                                                      piece)


def pool_schedule_plain(starts: torch.Tensor, n_points: int,
                        piece: int = POOL_PIECE
                        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The pooling kernel's work split, in torch ops on any device and with
    no host read: one task per warp, a pillar's points cut into pieces of
    at most ``piece`` points.

    A pillar of at most ``piece`` points is one task, which writes the
    pillar's rows.  A longer one is ``ceil(n / piece)`` tasks; each writes
    an fp32 partial block (its Dz vox rows and its bev row) into its own
    scratch slot, and the kernel's second pass adds a pillar's blocks in
    slot order.  The sizes follow the shapes (``n_points`` is P, in-grid
    or not), so the lists end in padding that the kernel skips.

    Returns:
      tasks: (n_pillars + P // piece, 4) int32 (pillar, first point, end
        point, slot or -1), the most points first (eight warps a block
        then have about as much to do, and the heaviest start first), ties
        in pillar and point order; then padding rows (n_pillars, P_in,
        P_in, -1).  A split pillar's slots follow its pieces' point order.
      splits: (min(n_pillars, P // (piece + 1)), 4) int32 (pillar, first
        slot, pieces, 0) of the pillars of more than ``piece`` points in
        order, then padding rows (n_pillars, 0, 0, 0).
      n_slots: 2 * (P // piece), at least the slots used.
    """
    n_pillars = starts.numel() - 1
    n_tasks, n_splits, n_slots = _schedule_sizes(n_pillars, n_points, piece)
    s = starts.long()
    pieces = (s[1:] - s[:-1] + (piece - 1)).div_(
        piece, rounding_mode="floor").clamp_(min=1)
    last = pieces.cumsum(0)                 # one past each pillar's tasks
    split = pieces > 1
    n_split = pieces * split
    slots_end = n_split.cumsum(0)
    # per pillar: its first point, its end, its first slot (-1 unless
    # split), its first task
    table = torch.stack([s[:-1], s[1:],
                         torch.where(split, slots_end - n_split, -1),
                         last - pieces], -1)
    t = torch.arange(n_tasks, device=s.device)
    pillar = torch.searchsorted(last, t, right=True)   # n_pillars: padding
    real = pillar < n_pillars
    row = table[pillar.clamp_(max=n_pillars - 1)]
    k = t - row[:, 3]                       # the task's piece of its pillar
    # padding runs past its last pillar: both ends clamp to P_in
    p0 = torch.minimum(row[:, 0] + k * piece, row[:, 1])
    p1 = torch.minimum(p0 + piece, row[:, 1])
    slot = torch.where(real & (row[:, 2] >= 0), row[:, 2] + k, -1)
    pillar = torch.where(real, pillar, n_pillars)
    order = torch.sort((p1 - p0) * 2 + real, descending=True,
                       stable=True).indices
    tasks = torch.stack([pillar, p0, p1, slot], -1)[order].to(torch.int32)

    # the split pillars in order, at their rank among them; padding rows
    # (n_pillars, 0, 0, 0), the others dropped into a spare last row
    splits = torch.zeros((n_splits + 1, 4), dtype=torch.int32,
                         device=s.device)
    splits[:, 0] = n_pillars
    q = torch.arange(n_pillars, device=s.device)
    rank = torch.where(split, split.cumsum(0) - 1, n_splits)
    splits[rank] = torch.stack(
        [q, slots_end - n_split, pieces, q * 0], -1).to(torch.int32)
    return tasks, splits[:n_splits], n_slots


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    """The kernel's C entry for ``dtype`` (or the plan's, for ``"plan"``),
    its ctypes signature set once."""
    if dtype == "plan":
        fn = load("mghs_pool").mghs_pool_plan
        fn.argtypes = _PLAN_ARGTYPES
        fn.restype = ctypes.c_int
        return fn
    fn = getattr(load("mghs_pool"), _FN[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def mghs_pool_plan_plain(depth: torch.Tensor, feat: torch.Tensor,
                         band_mask: torch.Tensor, plan: PoolPlan,
                         acc_dtype: torch.dtype = torch.float32
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same inputs and plan, and an
    ``index_add_`` over the sorted key.  Arguments as :func:`mghs_pool_cuda`;
    ``acc_dtype`` float64 sums the same products exactly (the reference
    that B1's fp32 sums are held to on the card: the fp32 ``index_add_``
    rounds as much as the kernel does, in the order its atomics take).
    """
    b, dy, dx, dz = plan.grid
    d, c = depth.shape[-1], feat.shape[-1]
    n_pillars = plan.starts.numel() - 1
    n_valid = int(plan.starts[-1])
    dix = plan.dix_s[:n_valid].long()
    z = plan.z_s[:n_valid].long()
    pix = dix // d
    pillar = torch.repeat_interleave(
        torch.arange(n_pillars, device=dix.device),
        (plan.starts[1:] - plan.starts[:-1]).long(), output_size=n_valid)
    # the product in the working dtype, summed in fp32, as in the kernel
    v = (depth.reshape(-1)[dix, None] * feat.reshape(-1, c)[pix]).to(
        acc_dtype)
    e0, e1 = plan.band_edges
    band = (z >= e0).long() + (z >= e1).long()
    gate = (z >= 0) & (band_mask.reshape(-1, 3)[pix, band] > 0)
    bev = torch.zeros(n_pillars, c, dtype=acc_dtype, device=v.device)
    bev.index_add_(0, pillar, v)
    vox = torch.zeros(n_pillars * dz, c, dtype=acc_dtype, device=v.device)
    vox.index_add_(0, (pillar * dz + z)[gate], v[gate])
    return (bev.to(feat.dtype).reshape(b, dy, dx, c),
            vox.to(feat.dtype).reshape(b, dy, dx, dz, c))


def mghs_pool_cuda(depth: torch.Tensor, feat: torch.Tensor,
                   band_mask: torch.Tensor, plan: PoolPlan
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused MGHS pooling.

    Args:
      depth: (B, N, fH, fW, D) softmaxed depth, pixel-major.
      feat: (B, N, fH, fW, C) context features.
      band_mask: (B, N, fH, fW, 3) per-pixel height-band gate in {0, 1}.
      plan: :func:`dhd_tpu_torch.ops.voxel_pool.build_pool_plan` output.
    Returns:
      bev (B, Dy, Dx, C) and vox (B, Dy, Dx, Dz, C) in feat.dtype.

    On a CUDA tensor this launches the kernel or raises; a tensor on the
    CPU takes the plain version.  ``profiling.kernel_launches()`` counts
    its kernel launches.  A trace (``torch.export``) records the launch as
    the custom op ``dhd_tpu_torch::mghs_pool``.  Where autograd records the
    call, the result is differentiable in ``depth`` and ``feat``
    (:class:`_MGHSPool`); ``band_mask`` and the plan get no gradient, as in
    JAX, where the gate is a hard select.
    """
    if records_grad(depth, feat):
        return _MGHSPool.apply(depth, feat, band_mask, plan)
    return _forward(depth, feat, band_mask, plan)



def _forward(depth: torch.Tensor, feat: torch.Tensor,
             band_mask: torch.Tensor, plan: PoolPlan
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if depth.device.type == "cpu":
        return mghs_pool_plan_plain(depth, feat, band_mask, plan)
    if depth.device.type != "cuda":
        raise ValueError(f"unsupported device {depth.device}")
    b, dy, dx, dz = plan.grid
    pix_shape = depth.shape[:-1]
    d, c = depth.shape[-1], feat.shape[-1]
    if feat.dtype not in _FN:
        raise TypeError(f"mghs_pool_cuda takes bf16 or fp32, not {feat.dtype}")
    for name, t, shape in (("depth", depth, pix_shape + (d,)),
                           ("feat", feat, pix_shape + (c,)),
                           ("band_mask", band_mask, pix_shape + (3,))):
        if t.dtype != feat.dtype or t.device != feat.device \
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {feat.dtype} "
                             f"{tuple(shape)} on {feat.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    n_pillars = b * dy * dx
    p = plan.dix_s.numel()
    if plan.tasks is None or plan.splits is None:
        raise ValueError("plan has no kernel schedule: build the plan from "
                         "tensors on the card")
    for name, t, shape in (("dix_s", plan.dix_s, (p,)),
                           ("z_s", plan.z_s, (p,)),
                           ("starts", plan.starts, (n_pillars + 1,)),
                           ("tasks", plan.tasks, (plan.tasks.shape[0], 4)),
                           ("splits", plan.splits, (plan.splits.shape[0], 4))):
        if t.dtype != torch.int32 or t.device != feat.device \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"plan.{name}: want a contiguous int32 {shape} "
                             f"on {feat.device}")
    if c < 1 or dz < 1:
        raise ValueError(f"unsupported C={c}, Dz={dz}")
    if pix_shape.numel() * d >= 2 ** 31:
        raise ValueError("depth table too large for int32 indices")
    e0, e1 = plan.band_edges
    return _mghs_pool(depth, feat, band_mask, plan.dix_s, plan.z_s,
                      plan.tasks, plan.splits, list(plan.grid), plan.n_slots,
                      e0, e1)


def _launch(depth: torch.Tensor, feat: torch.Tensor, band_mask: torch.Tensor,
            dix_s: torch.Tensor, z_s: torch.Tensor, tasks: torch.Tensor,
            splits: torch.Tensor, grid: List[int], n_slots: int, e0: int,
            e1: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on checked CUDA tensors and a plan's tensors: the custom
    op's implementation."""
    for name, t in (("plan.tasks", tasks), ("plan.splits", splits)):
        if t.data_ptr() % 16:       # read as int4
            raise ValueError(f"{name}: want 16-byte aligned rows")
    b, dy, dx, dz = grid
    d, c = depth.shape[-1], feat.shape[-1]
    bev = torch.empty((b, dy, dx, c), dtype=feat.dtype, device=feat.device)
    vox = torch.empty((b, dy, dx, dz, c), dtype=feat.dtype,
                      device=feat.device)
    # fp32 partial blocks (Dz vox rows and a bev row) of split pillars
    scratch = torch.empty(n_slots * (dz + 1) * c, dtype=torch.float32,
                          device=feat.device)
    profiling.mark("mghs_pool_kernel")
    err = _entry(feat.dtype)(
        depth.data_ptr(), feat.data_ptr(), band_mask.data_ptr(),
        dix_s.data_ptr(), z_s.data_ptr(), tasks.data_ptr(),
        splits.data_ptr(), scratch.data_ptr(), bev.data_ptr(),
        vox.data_ptr(), tasks.shape[0], splits.shape[0], b * dy * dx,
        c, d, dz, e0, e1, *lanes_per_point(feat),
        torch._C._cuda_getCurrentRawStream(feat.get_device()))
    if err != 0:
        raise RuntimeError(f"mghs_pool kernel launch failed: CUDA error {err}")
    profiling.count("mghs_pool_cuda")
    return bev, vox


def _mghs_pool_fake(depth, feat, band_mask, dix_s, z_s, tasks, splits, grid,
                    n_slots, e0, e1):
    b, dy, dx, dz = grid
    c = feat.shape[-1]
    return (feat.new_empty((b, dy, dx, c)),
            feat.new_empty((b, dy, dx, dz, c)))


_mghs_pool = kernel_op("mghs_pool", _launch, _mghs_pool_fake)


def mghs_pool_plan_grads(depth: torch.Tensor, feat: torch.Tensor,
                         band_mask: torch.Tensor, plan: PoolPlan,
                         g_bev: torch.Tensor, g_vox: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of the pooling in ``depth`` and ``feat`` from those of bev
    and vox, in torch ops: the JAX package's ``_dual_fused_bwd`` in the
    port's layout.  Per sorted point in the grid, with ``g = g_bev[pillar]
    + gate * g_vox[pillar * Dz + z]``::

        d_depth[dix] = sum_c feat[pix, c] * g[c]
        d_feat[pix] += depth[dix] * g         (an index_add_ over pixels)

    The products are fp32, cast to the inputs' dtypes.  No host sync: each
    point's pillar comes from a search over ``plan.starts``, and points
    past the grid's last pillar get none.
    """
    b, dy, dx, dz = plan.grid
    d, c = depth.shape[-1], feat.shape[-1]
    n_pillars = b * dy * dx
    p = plan.dix_s.numel()
    dix = plan.dix_s.long()
    z = plan.z_s.long()
    pix = dix // d
    pillar = torch.searchsorted(
        plan.starts, torch.arange(p, dtype=torch.int32, device=dix.device),
        right=True) - 1
    in_grid = (pillar < n_pillars)[:, None]
    pillar = pillar.clamp(max=n_pillars - 1)
    e0, e1 = plan.band_edges
    band = (z >= e0).long() + (z >= e1).long()
    gate = (z >= 0) & (band_mask.reshape(-1, 3)[pix, band] > 0)
    g = g_bev.reshape(-1, c).float()[pillar]
    g_v = g_vox.reshape(-1, c).float()[pillar * dz + z.clamp(min=0)]
    g = torch.where(in_grid, g + torch.where(gate[:, None], g_v, 0.0), 0.0)
    feat_rows = feat.reshape(-1, c)
    d_depth = torch.zeros(depth.numel(), dtype=torch.float32,
                          device=depth.device)
    d_depth.index_add_(0, dix, (feat_rows.float()[pix] * g).sum(-1))
    d_feat = torch.zeros(feat_rows.shape, dtype=torch.float32,
                         device=feat.device)
    d_feat.index_add_(0, pix, depth.reshape(-1).float()[dix, None] * g)
    return (d_depth.to(depth.dtype).reshape(depth.shape),
            d_feat.to(feat.dtype).reshape(feat.shape))


class _MGHSPool(torch.autograd.Function):
    """Forward: the kernel (the plain plan version on the CPU).  Backward:
    :func:`mghs_pool_plan_grads`."""

    @staticmethod
    def forward(ctx, depth, feat, band_mask, plan):
        ctx.save_for_backward(depth, feat, band_mask)
        ctx.plan = plan
        return _forward(depth, feat, band_mask, plan)

    @staticmethod
    def backward(ctx, g_bev, g_vox):
        depth, feat, band_mask = ctx.saved_tensors
        plan = ctx.plan
        b, dy, dx, dz = plan.grid
        c = feat.shape[-1]
        if g_bev is None:
            g_bev = feat.new_zeros((b, dy, dx, c))
        if g_vox is None:
            g_vox = feat.new_zeros((b, dy, dx, dz, c))
        d_depth, d_feat = mghs_pool_plan_grads(depth, feat, band_mask, plan,
                                               g_bev, g_vox)
        return (d_depth if ctx.needs_input_grad[0] else None,
                d_feat if ctx.needs_input_grad[1] else None, None, None)
