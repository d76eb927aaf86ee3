"""Stereo matching cost volume in plain PyTorch: the port's stepwise warp
plan (``build_cv_plan``), its plain cost (``cv_cost_plain``) and the
softmax over depth, frozen.  No rig-static plan half is kept: every call
plans from the geometry."""
from __future__ import annotations

from typing import Tuple

import torch

from bench_port.reference.geometry import inverse_3x3

SENTINEL = -1e4     # a source coordinate whose four taps all miss the map


def stereo_reproject_grid(frustum: torch.Tensor, k2s_sensor: torch.Tensor,
                          intrins: torch.Tensor, post_rots: torch.Tensor,
                          post_trans: torch.Tensor, img_h: int, img_w: int
                          ) -> torch.Tensor:
    """Normalised sampling grid taking current pixels + depth to previous
    pixels (DepthNet.gen_grid, depthnet.py:249-308).

    Args:
      frustum: (D, Hs, Ws, 3) stereo-resolution frustum.
      k2s_sensor: (B, N, 4, 4) current -> previous camera.
      intrins, post_rots: (B, N, 3, 3); post_trans: (B, N, 3).
    Returns:
      (B, N, D, Hs, Ws, 2) (x, y) in [-1, 1]; points behind the previous
      camera (z < 1e-3) at -2.
    """
    pts = frustum[None, None] - post_trans[:, :, None, None, None, :]
    pts = torch.einsum("bnij,bndhwj->bndhwi", inverse_3x3(post_rots), pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    combine = torch.einsum("bnij,bnjk->bnik", k2s_sensor[:, :, :3, :3],
                           inverse_3x3(intrins))
    pts = torch.einsum("bnij,bndhwj->bndhwi", combine, pts)
    pts = pts + k2s_sensor[:, :, None, None, None, :3, 3]
    neg = pts[..., 2] < 1e-3
    pts = torch.einsum("bnij,bndhwj->bndhwi", intrins, pts)
    uv = pts[..., :2] / pts[..., 2:3]
    uv = torch.einsum("bnij,bndhwj->bndhwi", post_rots[:, :, :2, :2], uv)
    uv = uv + post_trans[:, :, None, None, None, :2]
    px = uv[..., 0] / (img_w - 1.0) * 2.0 - 1.0
    py = uv[..., 1] / (img_h - 1.0) * 2.0 - 1.0
    # the division above may give inf/nan where z ~ 0: replaced here
    px = torch.where(neg, -2.0, px)
    py = torch.where(neg, -2.0, py)
    return torch.stack([px, py], dim=-1)


def build_cv_plan(frustum: torch.Tensor, k2s_sensor: torch.Tensor,
                  intrins: torch.Tensor, post_rots: torch.Tensor,
                  post_trans: torch.Tensor, hs: int, ws: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Geometry-only warp plan: fractional source coordinates.

    Returns ``uf, vf``, each (B*N, D, Hs, Ws) fp32, in stereo-grid units
    (the ``align_corners=True`` unnormalisation of the grid).  Samples
    behind the camera or with every tap off the map hold :data:`SENTINEL`,
    which gives all-zero tap weights, as zero padding does.
    """
    b, n = k2s_sensor.shape[:2]
    d = frustum.shape[0]
    grid = stereo_reproject_grid(frustum, k2s_sensor, intrins, post_rots,
                                 post_trans, hs * 4, ws * 4)
    px, py = grid[..., 0], grid[..., 1]
    uf = (px + 1.0) * 0.5 * (ws - 1)
    vf = (py + 1.0) * 0.5 * (hs - 1)
    invalid = ((px <= -2.0) | (uf <= -1.0) | (uf >= ws)
               | (vf <= -1.0) | (vf >= hs))
    uf = torch.where(invalid, SENTINEL, uf).reshape(b * n, d, hs, ws)
    vf = torch.where(invalid, SENTINEL, vf).reshape(b * n, d, hs, ws)
    return uf.contiguous(), vf.contiguous()


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


@torch.no_grad()
def stereo_cost_volume(prev_feat: torch.Tensor, curr_feat: torch.Tensor,
                       frustum: torch.Tensor, k2s_sensor: torch.Tensor,
                       intrins: torch.Tensor, post_rots: torch.Tensor,
                       post_trans: torch.Tensor, bias: float = 0.0
                       ) -> torch.Tensor:
    """Softmaxed depth probabilities (B, N, D, Hs, Ws) fp32 of the current
    stereo features (B, N, Hs, Ws, C) against the previous ones."""
    b, n, hs, ws, c = curr_feat.shape
    uf, vf = build_cv_plan(frustum, k2s_sensor, intrins, post_rots,
                           post_trans, hs, ws)
    prev = prev_feat.reshape(b * n, hs, ws, c).contiguous()
    curr = curr_feat.reshape(b * n, hs, ws, c).contiguous()
    cost = cv_cost_plain(prev, curr, uf, vf, bias)
    prob = torch.softmax(-cost, dim=1)
    return prob.reshape(b, n, -1, hs, ws)
