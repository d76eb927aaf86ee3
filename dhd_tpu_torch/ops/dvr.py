"""Differentiable volume rendering (dvr.render), the 4D-occ training path:
counterpart of ``dhd_tpu/ops/dvr.py``.

Reference: lib/dvr/dvr.cu:391-648 (render_cuda_kernel) + dvr.cpp:51-59.
The CUDA kernel ray-marches a density grid with 3D-DDA (Amanatides-Woo),
computes the expected ray termination distance

    exp_d = sum_i p_i * d_i + p_out * max_d,
    p_i   = exp(-csd_{i-1}) - exp(-csd_i),  csd_i = sum_{k<=i} sigma_k dt_k,
    p_out = exp(-csd_last),

and hand-writes the gradient d(loss)/d(sigma) ("option 2: cap at the
boundary", dvr.cu:603-648), which is exactly the autodiff gradient of
exp_d as written.  Here the forward is torch ops over the rays on the
grid's device (the DDA step of ``eval/rayiou.py``), and autograd gives
the gradient: the gathers' backward scatter-adds, with atomics on the GPU,
so a GPU's grad_sigma sums in no fixed order (equal to a fixed-order sum
within fp32 rounding of the summed terms, not bit for bit).

Shapes follow the reference API: sigma (N, T, Z, Y, X); origin (N, T, 3)
and points (N, M, 3) in *voxel units* with (x, y, z) component order;
tindex (N, M) with t < 0 marking padded rays.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from dhd_tpu_torch.device import device_constant
from dhd_tpu_torch.eval.rayiou import EXIT_CHECK, dda_axis, dda_start

_LOSSES = ("l1", "l2", "absrel")


def render_rays(sigma_flat: torch.Tensor, origins: torch.Tensor,
                endpts: torch.Tensor, zyx: Tuple[int, int, int],
                base: Optional[torch.Tensor] = None, max_steps: int = 448
                ) -> Tuple[torch.Tensor, ...]:
    """Expected-depth render of M rays through a density grid
    (differentiable in ``sigma_flat``).

    Args:
      sigma_flat: (S,) flattened nonnegative densities; a ray's voxel
        (x, y, z) reads ``sigma_flat[base + (z * Y + y) * X + x]``.
      origins: (M, 3) per-ray origins, voxel units, (x, y, z).
      endpts: (M, 3) per-ray endpoints (the lidar returns).
      zyx: grid extent (Z, Y, X).
      base: (M,) int64 flat offset per ray (selects the (n, t) slice);
        zeros when omitted.
      max_steps: DDA traversal budget (>= X+Y+Z+slack for in-grid origins).

    Returns:
      exp_d: (M,) expected termination distance (voxel units); 0 for rays
        that never enter the grid.
      gt_cap: (M,) ||endpt - origin|| capped at the last in-grid exit
        distance (the reference's gt_d capping, dvr.cu:594).
      entered: (M,) bool, the ray visited >= 1 in-grid voxel.
      truncated: (M,) bool, the ray was still traversing in-grid when the
        ``max_steps`` budget ran out (its exp_d is partially accumulated).
    """
    dev = sigma_flat.device
    vz, vy, vx = zyx
    size = device_constant((vx, vy, vz), dev, torch.int32)
    m = endpts.shape[0]
    if base is None:
        base = torch.zeros((m,), dtype=torch.int64, device=dev)
    gt_d, v, step, tmax, tdelta = dda_start(origins, endpts, eps=1e-12)
    zeros = torch.zeros((m,), dtype=torch.float32, device=dev)
    last_d = csd = exp_d = max_d = zeros
    was_inside = done = entered = torch.zeros((m,), dtype=torch.bool,
                                              device=dev)
    for it in range(max_steps):
        inside = ((v >= 0) & (v < size)).all(dim=-1)
        new_done = (done | (was_inside & ~inside)
                    | (~was_inside & ~inside & (last_d > gt_d)))
        onehot, d = dda_axis(tmax)
        # accumulate the voxel just exited (only while active and inside)
        active = inside & ~done
        vc = torch.minimum(torch.clamp(v, min=0), size - 1).long()
        sig = sigma_flat[base + (vc[:, 2] * vy + vc[:, 1]) * vx + vc[:, 0]]
        delta = torch.clamp(d - last_d, min=0.0)
        new_csd = csd + torch.where(active, sig * delta, 0.0)
        p = torch.exp(-csd) - torch.exp(-new_csd)      # 0 where sd == 0
        exp_d = exp_d + torch.where(active, p * d, 0.0)
        max_d = torch.where(active, d, max_d)
        csd = new_csd
        keep = done[:, None]
        v = torch.where(keep, v, v + step * onehot)
        tmax = torch.where(keep, tmax, tmax + tdelta * onehot)
        last_d = torch.where(done, last_d, d)
        was_inside = was_inside | inside
        entered = entered | inside
        # a ray done before this step stood still in it (its last move, in
        # the step that made it done, could still enter the grid), and
        # changes nothing more: stop once every ray is
        settled = done
        done = new_done
        if (it + 1) % EXIT_CHECK == 0 and bool(settled.all()):
            break

    # rays still walking in-grid at the budget's end were truncated
    inside_f = ((v >= 0) & (v < size)).all(dim=-1)
    truncated = ~done & inside_f
    # imaginary sample at the boundary (dvr.cu:590-595)
    exp_d = torch.where(entered, exp_d + torch.exp(-csd) * max_d, 0.0)
    gt_cap = torch.where(entered, torch.minimum(gt_d, max_d), gt_d)
    return exp_d, gt_cap, entered, truncated


def _flatten_rays(sigma, origin, points, tindex):
    n, t, vz, vy, vx = sigma.shape
    m = points.shape[1]
    ti = tindex.to(torch.int64)
    tc = torch.clamp(ti, 0, t - 1)
    ts = torch.zeros_like(tc) if t == 1 else tc
    bidx = torch.arange(n, device=sigma.device)[:, None].expand(n, m)
    base = (bidx * t + ts) * (vz * vy * vx)
    origins = torch.gather(origin, 1, tc[..., None].expand(n, m, 3))
    return (sigma.reshape(-1), origins.reshape(-1, 3),
            points.reshape(-1, 3), base.reshape(-1), ti.reshape(-1) >= 0,
            (vz, vy, vx), (n, m))


def render_expected_depth(sigma: torch.Tensor, origin: torch.Tensor,
                          points: torch.Tensor, tindex: torch.Tensor,
                          max_steps: int = 448):
    """Differentiable core of dvr.render: (pred_dist, gt_dist, valid).

    pred_dist/gt_dist are -1 for padded (tindex < 0) or never-inside rays,
    matching the reference's output init (dvr.cu:664-665).  Gradients of any
    function of ``pred_dist`` flow to ``sigma``.  Rays whose DDA walk was
    truncated by ``max_steps`` while still in-grid are reported invalid
    (-1) rather than returning a partially accumulated depth.
    """
    sflat, origins, endpts, base, unpadded, zyx, (n, m) = _flatten_rays(
        sigma, origin, points, tindex)
    exp_d, gt_cap, entered, truncated = render_rays(sflat, origins, endpts,
                                                    zyx, base, max_steps)
    valid = unpadded & entered & ~truncated
    pred = torch.where(valid, exp_d, -1.0).reshape(n, m)
    gt = torch.where(valid, gt_cap, -1.0).reshape(n, m)
    return pred, gt, valid.reshape(n, m)


def render(sigma: torch.Tensor, origin: torch.Tensor, points: torch.Tensor,
           tindex: torch.Tensor, loss_name: str = "l1",
           max_steps: int = 448):
    """dvr.render parity wrapper -> (pred_dist, gt_dist, grad_sigma), on
    ``sigma``'s device.

    grad_sigma is d(sum of per-ray losses)/d(sigma) for loss_name in
    {'l1', 'l2', 'absrel'} (dvr.cu:617-625; l2 means the gradient is
    (pred - gt), i.e. the 0.5*(pred-gt)^2 loss), by autograd through the
    renderer.
    """
    if loss_name not in _LOSSES:
        raise ValueError(f"loss_name must be one of {_LOSSES}")
    with torch.inference_mode(False), torch.enable_grad():
        s = sigma.detach().clone().requires_grad_(True)
        pred, gt, valid = render_expected_depth(s, origin, points, tindex,
                                                max_steps)
        diff = pred - gt
        if loss_name == "l1":
            per = diff.abs()
        elif loss_name == "l2":
            per = 0.5 * diff * diff
        else:
            per = diff.abs() / torch.clamp(gt, min=1e-12)
        total = torch.where(valid, per, 0.0).sum()
        (grad,) = torch.autograd.grad(total, s)
    return pred.detach(), gt.detach(), grad
