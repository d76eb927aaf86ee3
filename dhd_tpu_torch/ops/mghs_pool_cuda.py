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
3.35 TB/s.  Design (see the source): one block per BEV pillar walks the
pillar's sorted interval with one thread per channel, keeps the Dz x C vox
sums in shared memory and writes every output element once, so it needs no
atomics and no zero-fill pass.

:func:`mghs_pool_cuda` is differentiable in ``depth`` and ``feat``
(:class:`_MGHSPool`): the backward mirrors the JAX package's
``_dual_fused_bwd`` (``dhd_tpu/ops/pallas_pool.py:410-442``) in torch ops.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from dhd_tpu_torch.ops.cuda_build import load
from dhd_tpu_torch.ops.grad_mode import records_grad
from dhd_tpu_torch.ops.voxel_pool import PoolPlan

_FN = {torch.bfloat16: "mghs_pool_bf16", torch.float32: "mghs_pool_f32"}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_MAX_SMEM = 48 * 1024        # without opting in to more dynamic smem


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The kernel's C entry for ``dtype``, its ctypes signature set once."""
    fn = getattr(load("mghs_pool"), _FN[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def mghs_pool_plan_plain(depth: torch.Tensor, feat: torch.Tensor,
                         band_mask: torch.Tensor, plan: PoolPlan
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same inputs and plan, and an
    ``index_add_`` over the sorted key.  Arguments as :func:`mghs_pool_cuda`.
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
    v = (depth.reshape(-1)[dix, None] * feat.reshape(-1, c)[pix]).float()
    e0, e1 = plan.band_edges
    band = (z >= e0).long() + (z >= e1).long()
    gate = (z >= 0) & (band_mask.reshape(-1, 3)[pix, band] > 0)
    bev = torch.zeros(n_pillars, c, dtype=torch.float32, device=v.device)
    bev.index_add_(0, pillar, v)
    vox = torch.zeros(n_pillars * dz, c, dtype=torch.float32,
                      device=v.device)
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
    CPU takes the plain version.  ``mghs_pool_cuda.launches`` counts kernel
    launches.  Where autograd records the call, the result is
    differentiable in ``depth`` and ``feat`` (:class:`_MGHSPool`);
    ``band_mask`` and the plan get no gradient, as in JAX, where the gate
    is a hard select.
    """
    if records_grad(depth, feat):
        return _MGHSPool.apply(depth, feat, band_mask, plan)
    return _forward(depth, feat, band_mask, plan)


mghs_pool_cuda.launches = 0


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
    for name, t, n in (("dix_s", plan.dix_s, p), ("z_s", plan.z_s, p),
                       ("starts", plan.starts, n_pillars + 1)):
        if t.dtype != torch.int32 or t.device != feat.device \
                or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"plan.{name}: want {n} contiguous int32 on "
                             f"{feat.device}")
    if not 0 < c <= 1024 or 4 * (dz * c + 3 * c) > _MAX_SMEM:
        raise ValueError(f"unsupported C={c}, Dz={dz}")
    if pix_shape.numel() * d >= 2 ** 31:
        raise ValueError("depth table too large for int32 indices")

    bev = torch.empty((b, dy, dx, c), dtype=feat.dtype, device=feat.device)
    vox = torch.empty((b, dy, dx, dz, c), dtype=feat.dtype,
                      device=feat.device)
    e0, e1 = plan.band_edges
    err = _entry(feat.dtype)(
        depth.data_ptr(), feat.data_ptr(), band_mask.data_ptr(),
        plan.dix_s.data_ptr(), plan.z_s.data_ptr(), plan.starts.data_ptr(),
        bev.data_ptr(), vox.data_ptr(), n_pillars, c, d, dz, e0, e1,
        torch._C._cuda_getCurrentRawStream(feat.get_device()))
    if err != 0:
        raise RuntimeError(f"mghs_pool kernel launch failed: CUDA error {err}")
    mghs_pool_cuda.launches += 1
    return bev, vox


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
