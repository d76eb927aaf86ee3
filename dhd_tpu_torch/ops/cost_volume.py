"""Stereo matching cost volume (model_utils/depthnet.py:249-361):
counterpart of ``dhd_tpu/ops/cost_volume.py`` and of the plan builder of
``dhd_tpu/ops/cost_volume_pallas.py``.

For every stereo-resolution pixel and depth bin of the current frame,
reproject into the previous frame's camera, sample the previous stereo
features bilinearly, and sum the absolute difference to the current
features over the channels; softmax(-cost) over depth.  The geometry goes
into a plan of fractional source coordinates (:func:`build_cv_plan`); the
cost is kernel B3 (:mod:`dhd_tpu_torch.ops.cost_volume_cuda`) or its plain
version.  The whole op is a constant under autodiff, like the reference's
``@torch.no_grad``.

A fixed camera rig splits the plan (:func:`build_cv_static`, once per rig;
:func:`cv_plan_from_static`, once per frame), as the JAX package's
streaming serving does; the TPU kernel's row windows, lane tiles and padded
lanes have no counterpart here, since B3 reads any row.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from dhd_tpu_torch.geometry import inverse_3x3
from dhd_tpu_torch.ops.cost_volume_cuda import (cv_cost_plain,
                                                stereo_cost_volume_cuda)

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


def build_cv_static(frustum: torch.Tensor, intrins: torch.Tensor,
                    post_rots: torch.Tensor, post_trans: torch.Tensor,
                    hs: int, ws: int) -> Dict[str, torch.Tensor]:
    """Rig-static half of the warp plan (``cost_volume_pallas.py:207-256``).

    The reprojection splits at the inter-frame pose: undoing the image aug
    and unprojecting to (u·d, v·d, d) depends on the current rig only, and
    everything after the pose composes into one projective 3x4 per camera
    (:func:`cv_plan_from_static`).

    Args:
      frustum: (D, Hs, Ws, 3) stereo-resolution frustum.
      intrins, post_rots: (B, N, 3, 3); post_trans: (B, N, 3).
    Returns:
      ``p0`` (B*N, 3, D*Hs*Ws) fp32 unprojected points; ``fold`` (B, N, 2,
      3), the image aug re-applied after the division and scaled from
      pixels to stereo-grid units, over [x, y, w]; ``intrins`` fp32; the
      ints ``hs``, ``ws``.
    """
    b, n = intrins.shape[:2]
    d = frustum.shape[0]
    pts = frustum[None, None] - post_trans[:, :, None, None, None, :]
    pts = torch.einsum("bnij,bndhwj->bndhwi", inverse_3x3(post_rots), pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    p0 = pts.reshape(b * n, d * hs * ws, 3).transpose(1, 2).contiguous()
    # uf = (px + 1) / 2 * (ws - 1) with px = u / (img_w - 1) * 2 - 1
    sx = (ws - 1.0) / (ws * 4 - 1.0)
    sy = (hs - 1.0) / (hs * 4 - 1.0)
    fold = torch.cat([post_rots[:, :, :2, :2], post_trans[:, :, :2, None]],
                     dim=-1).float()
    fold = fold * fold.new_tensor([[sx], [sy]])
    return {"p0": p0, "fold": fold, "intrins": intrins.float(),
            "hs": hs, "ws": ws}


def cv_plan_from_static(static: Dict[str, torch.Tensor],
                        k2s_sensor: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame warp plan from :func:`build_cv_static` and the current ->
    previous camera transform ``k2s_sensor`` (B, N, 4, 4)
    (``cost_volume_pallas.py:259-326``): one composed projective 3x4 per
    camera, ``xyw = Q @ [p0; 1]``, ``uf = x / w``, ``vf = y / w``.

    Returns ``uf, vf`` as :func:`build_cv_plan` does, (B*N, D, Hs, Ws)
    fp32 with the same :data:`SENTINEL` rule.  The composed chain rounds
    differently from the stepwise one, so coordinates differ by fp32
    rounding; ``method="xla"`` keeps the stepwise plan as the oracle.
    """
    b, n = k2s_sensor.shape[:2]
    hs, ws = static["hs"], static["ws"]
    intr = static["intrins"]
    rots = k2s_sensor[:, :, :3, :3].float()
    trans = k2s_sensor[:, :, :3, 3:].float()
    # Q = [K R K^-1 | K t]; K's third row is [0, 0, 1], so Q's third row
    # gives the depth in the previous camera
    q = torch.cat([intr @ rots @ inverse_3x3(intr), intr @ trans], dim=-1)
    q = torch.cat([static["fold"] @ q, q[:, :, 2:]], dim=2)
    q = q.reshape(b * n, 3, 4)
    xyw = torch.baddbmm(q[..., 3:], q[..., :3], static["p0"])
    x, y, w = xyw.unbind(1)
    uf, vf = x / w, y / w
    invalid = ((w < 1e-3) | (uf <= -1.0) | (uf >= ws)
               | (vf <= -1.0) | (vf >= hs))
    uf = torch.where(invalid, SENTINEL, uf).reshape(b * n, -1, hs, ws)
    vf = torch.where(invalid, SENTINEL, vf).reshape(b * n, -1, hs, ws)
    return uf.contiguous(), vf.contiguous()


@torch.no_grad()
def stereo_cost_volume(prev_feat: torch.Tensor, curr_feat: torch.Tensor,
                       frustum: torch.Tensor, k2s_sensor: torch.Tensor,
                       intrins: torch.Tensor, post_rots: torch.Tensor,
                       post_trans: torch.Tensor, bias: float = 0.0,
                       method: str = "auto",
                       static: Optional[Dict[str, torch.Tensor]] = None
                       ) -> torch.Tensor:
    """Softmaxed depth probability volume from two stereo feature maps.

    Args:
      prev_feat, curr_feat: (B, N, Hs, Ws, C) stride-4 stereo features.
      frustum: (D, Hs, Ws, 3) stereo-resolution frustum.
      k2s_sensor: (B, N, 4, 4) current -> previous camera.
      intrins, post_rots: (B, N, 3, 3); post_trans: (B, N, 3).
      bias: added to the cost of invalid samples (5.0 for DHD-M/L).
      method: 'xla' forces the plain version; otherwise the kernel on a
        GPU (the plain version on the CPU).
      static: optional rig-static plan half (:func:`build_cv_static` of
        this rig): the kernel path then builds its plan with
        :func:`cv_plan_from_static`; 'xla' ignores it and keeps the
        stepwise plan, as the JAX package does.
    Returns:
      (B, N, D, Hs, Ws) fp32 probabilities.
    """
    b, n, hs, ws, c = curr_feat.shape
    if static is not None and method != "xla":
        uf, vf = cv_plan_from_static(static, k2s_sensor)
    else:
        uf, vf = build_cv_plan(frustum, k2s_sensor, intrins, post_rots,
                               post_trans, hs, ws)
    prev = prev_feat.reshape(b * n, hs, ws, c).contiguous()
    curr = curr_feat.reshape(b * n, hs, ws, c).contiguous()
    if method == "xla":
        cost = cv_cost_plain(prev, curr, uf, vf, bias)
    else:
        cost = stereo_cost_volume_cuda(prev, curr, uf, vf, bias)
    prob = torch.softmax(-cost, dim=1)
    return prob.reshape(b, n, -1, hs, ws)
