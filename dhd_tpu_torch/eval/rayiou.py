"""RayIoU evaluation (core/evaluation/ray_metrics.py + lib/dvr/dvr.cu):
counterpart of ``dhd_tpu/eval/rayiou.py``.

The reference JIT-compiles a CUDA 3D-DDA (Amanatides-Woo) voxel traversal
(dvr.render_forward, dvr.cu:70-311); the JAX package runs it as one
vectorised ``fori_loop`` over all rays.  Here it is the same step in torch
ops on the grid's device (:func:`march`): each step advances every ray one
voxel border and records the exit distance of the first occupied voxel.
Each ray carries its own origin and grid offset, so one call marches every
origin of a sample through both the prediction and the ground truth.  A
ray's numbers never depend on the other rays of a call, and the loop stops
early only once no ray can change any more: the results equal those of
per-origin calls of 448 steps each.  The lidar ray fan, the
ego-trajectory origins and the per-class TP counting at 1/2/4 m are the
JAX package's numpy, copied.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dhd_tpu_torch.config import OCC_CLASS_NAMES
from dhd_tpu_torch.data.nuscenes import pose_to_mat
from dhd_tpu_torch.device import device_constant, resolve_device

PC_RANGE = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
VOXEL_SIZE = 0.4
FREE_ID = len(OCC_CLASS_NAMES) - 1
BIG = 1e30
EXIT_CHECK = 16         # steps between checks that every ray has settled

Device = Union[str, torch.device, None]


def generate_lidar_rays() -> np.ndarray:
    """nuScenes-like pitch fan x 360 azimuths (ray_metrics.py:56-79)."""
    pitch = []
    for k in range(10):
        pitch.append(-(math.pi / 2 - math.atan(k + 1)))
    while pitch[-1] < 0.21:
        delta = pitch[-1] - pitch[-2]
        pitch.append(pitch[-1] + delta)
    rays = []
    for p in pitch:
        for az_deg in np.arange(0, 360, 1):
            az = np.deg2rad(az_deg)
            rays.append((np.cos(p) * np.cos(az), np.cos(p) * np.sin(az),
                         np.sin(p)))
    return np.array(rays, dtype=np.float32)


def dda_start(origins: torch.Tensor, endpts: torch.Tensor, eps: float = 0.0):
    """The DDA's start state of rays from ``origins`` to ``endpts`` (M, 3),
    voxel units, fp32: (ray length (M,), start voxel (M, 3) int32, step
    direction (M, 3) int32, distance to the first border per axis (M, 3),
    distance between borders per axis (M, 3)), with the JAX package's
    arithmetic (the norm as ``torch.linalg.norm``, truncation toward zero,
    axes parallel to the ray at ``BIG``).  ``eps`` floors the length in
    the division (the renderer's 1e-12)."""
    rv = endpts - origins
    gt_d = torch.linalg.norm(rv, dim=-1)
    dirs = rv / (gt_d[:, None] if not eps
                 else torch.clamp(gt_d[:, None], min=eps))
    step = torch.where(dirs >= 0, 1, -1).to(torch.int32)
    v0 = origins.to(torch.int32)
    next_bound = v0 + (step > 0).to(torch.int32)
    # both branches are evaluated: keep the division by zero out of them
    flat = dirs == 0
    safe = torch.where(flat, 1.0, dirs)
    tmax = torch.where(flat, BIG, (next_bound - origins) / safe)
    tdelta = torch.where(flat, BIG, step / safe)
    return gt_d, v0, step, tmax, tdelta


def dda_axis(tm: torch.Tensor):
    """The axis each ray crosses next, by the CUDA tie-break (dvr.cu:
    209-229): X if tMaxX < tMaxY and < tMaxZ, else Z; or Y if tMaxY <
    tMaxZ, else Z.  Returns (one-hot (M, 3) bool, the crossing distance
    (M,))."""
    t0, t1, t2 = tm.unbind(-1)
    lt01 = t0 < t1
    pick_x = lt01 & (t0 < t2)
    pick_y = ~lt01 & (t1 < t2)
    pick_z = ~(pick_x | pick_y)
    return (torch.stack([pick_x, pick_y, pick_z], dim=-1),
            torch.where(pick_x, t0, torch.where(pick_y, t1, t2)))


def march(occ_flat: torch.Tensor, xyz: Tuple[int, int, int],
          origins: torch.Tensor, endpts: torch.Tensor,
          base: Optional[torch.Tensor] = None, max_steps: int = 448
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DDA first hit of M rays, each with its own origin and grid.

    Args:
      occ_flat: (S,) bool occupancy of one or more (X, Y, Z) grids, flat;
        a ray's voxel (x, y, z) reads ``occ_flat[base + (x*Y + y)*Z + z]``.
      xyz: grid extent (X, Y, Z).
      origins, endpts: (M, 3) fp32, voxel units, (x, y, z).
      base: (M,) int64 offset of each ray's grid (zeros when omitted).
      max_steps: traversal budget.
    Returns:
      :func:`ray_march`'s (dist, coord) per ray.
    """
    dev = occ_flat.device
    m = endpts.shape[0]
    sx, sy, sz = xyz
    size = device_constant(xyz, dev, torch.int32)
    if base is None:
        base = torch.zeros((m,), dtype=torch.int64, device=dev)
    _, v, step, tm, tdelta = dda_start(origins, endpts)
    found = torch.zeros((m,), dtype=torch.bool, device=dev)
    was_inside = torch.zeros_like(found)
    done = torch.zeros_like(found)
    last_d = torch.zeros((m,), dtype=torch.float32, device=dev)
    last_v = torch.zeros((m, 3), dtype=torch.int32, device=dev)
    for it in range(max_steps):
        # JAX records the hit in hit_d / hit_v and the last voxel before it
        # in last_d / last_v; both are written at the hit step and last_*
        # never after, so last_* alone is its answer
        inside = ((v >= 0) & (v < size)).all(dim=-1)
        done = done | (was_inside & ~inside)
        was_inside = was_inside | inside
        onehot, d = dda_axis(tm)
        vc = torch.minimum(torch.clamp(v, min=0), size - 1).long()
        occ_v = occ_flat[base + (vc[:, 0] * sy + vc[:, 1]) * sz + vc[:, 2]]
        upd = inside & ~done & ~found
        last_d = torch.where(upd, d, last_d)
        last_v = torch.where(upd[:, None], v, last_v)
        found = found | (upd & occ_v)
        keep = done[:, None]
        v = torch.where(keep, v, v + step * onehot)
        tm = torch.where(keep, tm, tm + tdelta * onehot)
        # a ray that is done (left the grid) or found its hit changes its
        # answer no more; stop once every ray is one of those
        if (it + 1) % EXIT_CHECK == 0 and bool((done | found).all()):
            break
    dist = torch.where(was_inside, last_d, 0.0)
    coord = torch.where(was_inside[:, None], last_v, 0)
    return dist, coord


def ray_march(occ: torch.Tensor, origin: torch.Tensor, endpts: torch.Tensor,
              max_steps: int = 448) -> Tuple[torch.Tensor, torch.Tensor]:
    """DDA first-hit along rays through a binary voxel grid, on ``occ``'s
    device.

    Args:
      occ: (X, Y, Z) binary occupancy (1 = occupied).
      origin: (3,) ray origin in voxel units (x, y, z).
      endpts: (M, 3) ray endpoints in voxel units.
      max_steps: traversal budget; 448 covers any ray whose origin lies
        inside the 200x200x16 grid (<= X+Y+Z+slack border crossings).
    Returns:
      dist: (M,) exit distance of the first occupied voxel (voxel units);
        falls back to the last in-grid voxel's exit distance, 0 if the ray
        never enters the grid.
      coord: (M, 3) int32 hit-voxel (x, y, z); last visited voxel when no
        hit, 0 when never inside.
    """
    dev = occ.device
    endpts = torch.as_tensor(endpts, dtype=torch.float32, device=dev)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    return march(occ.reshape(-1) > 0.5, tuple(occ.shape),
                 origin[None].expand_as(endpts), endpts,
                 max_steps=max_steps)


def init_voxelize(points: torch.Tensor, tindex: torch.Tensor,
                  grid_shape: Tuple[int, int, int, int, int]) -> torch.Tensor:
    """dvr.init parity (dvr.cu:19-66): mark each ray endpoint's voxel
    occupied.

    points: (N, M, 3) endpoint coords in voxel units (x, y, z);
    tindex: (N, M) time index (< 0 = padded); grid_shape (N, T, Z, Y, X).
    Returns a float32 occupancy grid on ``points``' device.
    """
    n, t, vz, vy, vx = grid_shape
    ts = torch.clamp(tindex.to(torch.int32), 0, t - 1)
    if t == 1:
        ts = torch.zeros_like(ts)
    v = points.to(torch.int32)
    x, y, z = v.unbind(-1)
    valid = ((tindex >= 0) & (x >= 0) & (x < vx) & (y >= 0) & (y < vy)
             & (z >= 0) & (z < vz))
    bidx = torch.arange(n, device=points.device)[:, None].expand_as(ts)
    flat = (((bidx * t + ts) * vz + z.clamp(0, vz - 1)) * vy
            + y.clamp(0, vy - 1)) * vx + x.clamp(0, vx - 1)
    occ = torch.zeros(n * t * vz * vy * vx, dtype=torch.float32,
                      device=points.device)
    occ.scatter_reduce_(0, torch.where(valid, flat, 0).reshape(-1).long(),
                        valid.reshape(-1).float(), "amax")
    return occ.reshape(grid_shape)


def ray_endpoints(lidar_rays: np.ndarray, origins: np.ndarray,
                   pc_range: Sequence[float], voxel_size: float):
    """Per-ray origins and endpoints in voxel units, (T*M, 3) each, origin
    by origin in the JAX package's numpy arithmetic."""
    offset = np.asarray(pc_range[:3], np.float32)
    m = lidar_rays.shape[0]
    o_vox, ends = [], []
    for o in np.asarray(origins):
        ends.append((lidar_rays + o - offset) / voxel_size)
        o_vox.append(np.broadcast_to((o - offset) / voxel_size, (m, 3)))
    return np.concatenate(o_vox), np.concatenate(ends)


def _march_grids(grids: List, lidar_rays: np.ndarray, origins: np.ndarray,
                 pc_range: Sequence[float], voxel_size: float,
                 device: torch.device) -> List[np.ndarray]:
    """The fan from every origin through each (X, Y, Z) class grid of
    ``grids``, in one march on ``device``: per grid the (T*M, 2) array of
    [semantic label at the hit voxel, hit distance in meters]."""
    sems = [g.cpu().numpy() if torch.is_tensor(g) else np.asarray(g)
            for g in grids]
    occ = torch.stack([torch.as_tensor(s, device=device) for s in sems])
    occ = (occ != FREE_ID).reshape(-1)
    o_vox, ends = ray_endpoints(lidar_rays, origins, pc_range, voxel_size)
    r = ends.shape[0]
    base = torch.arange(len(sems), device=device).repeat_interleave(r) \
        * (occ.numel() // len(sems))
    dist, coord = march(
        occ, sems[0].shape,
        torch.from_numpy(np.tile(o_vox, (len(sems), 1))).to(device),
        torch.from_numpy(np.tile(ends, (len(sems), 1))).to(device), base)
    dist = dist.cpu().numpy().reshape(len(sems), r) * voxel_size
    coord = coord.cpu().numpy().reshape(len(sems), r, 3)
    out = []
    for g, sem in enumerate(sems):
        labels = sem[coord[g, :, 0], coord[g, :, 1], coord[g, :, 2]]
        out.append(np.stack([labels.astype(np.float32), dist[g]], axis=-1))
    return out


def process_one_sample(sem, lidar_rays: np.ndarray, origins: np.ndarray,
                       pc_range: Sequence[float] = PC_RANGE,
                       voxel_size: float = VOXEL_SIZE,
                       device: Device = None) -> np.ndarray:
    """-> (T*M, 2) of [semantic label at hit voxel, hit distance in meters]
    (ray_metrics.py:82-135).  ``sem`` is a (Dx, Dy, Dz) class grid (numpy
    or a tensor); every origin's fan marches in one call on ``device``
    (default: the GPU; raises without one)."""
    return _march_grids([sem], lidar_rays, origins, pc_range, voxel_size,
                        resolve_device(device))[0]


def scene_origins(data_infos: Sequence[dict], index: int,
                  max_origins: int = 8) -> np.ndarray:
    """Lidar origins along the sample's scene trajectory, in the reference
    sample's (lidar-)ego frame, within +-39 m (ego_pose_dataset.py:56-94)."""
    info = data_infos[index]
    scene = [i for i in data_infos
             if i["scene_token"] == info["scene_token"]]

    def lidar2global(i):
        return pose_to_mat(i["ego2global_rotation"],
                           i["ego2global_translation"]) @ \
            pose_to_mat(i["lidar2ego_rotation"], i["lidar2ego_translation"])

    ref_inv = np.linalg.inv(lidar2global(info))
    ego_from_lidar = pose_to_mat(info["lidar2ego_rotation"],
                                 info["lidar2ego_translation"])
    origins = []
    for cand in scene:
        if cand["token"] == info["token"]:
            o = np.zeros(3, np.float32)
        else:
            o = (ref_inv @ lidar2global(cand))[:3, 3].astype(np.float32)
        o = (ego_from_lidar[:3] @ np.concatenate([o, [1.0]])).astype(
            np.float32)
        if abs(o[0]) < 39 and abs(o[1]) < 39:
            origins.append(o)
    if len(origins) > max_origins:
        sel = np.round(np.linspace(0, len(origins) - 1,
                                   max_origins)).astype(int)
        origins = [origins[i] for i in sel]
    return np.stack(origins)


def calc_rayiou(pcd_pred_list: List[np.ndarray],
                pcd_gt_list: List[np.ndarray]) -> Dict[str, float]:
    """Per-class TP/IoU at 1/2/4 m (ray_metrics.py:138-228)."""
    thresholds = (1.0, 2.0, 4.0)
    n_cls = len(OCC_CLASS_NAMES)
    gt_cnt = np.zeros(n_cls)
    pred_cnt = np.zeros(n_cls)
    tp_cnt = np.zeros((len(thresholds), n_cls))
    for pred, gt in zip(pcd_pred_list, pcd_gt_list):
        valid = gt[:, 0].astype(int) != FREE_ID
        pred, gt = pred[valid], gt[valid]
        l1 = np.abs(pred[:, 1] - gt[:, 1])
        for j, thr in enumerate(thresholds):
            ok = l1 < thr
            for i in range(n_cls):
                mp = pred[:, 0] == i
                mg = gt[:, 0] == i
                if j == 0:
                    gt_cnt[i] += mg.sum()
                    pred_cnt[i] += mp.sum()
                tp_cnt[j, i] += (mp & mg & ok).sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        ious = [(tp_cnt[j] / (gt_cnt + pred_cnt - tp_cnt[j]))[:-1]
                for j in range(len(thresholds))]
    return {
        "RayIoU": float(np.nanmean(ious)),
        "RayIoU@1": float(np.nanmean(ious[0])),
        "RayIoU@2": float(np.nanmean(ious[1])),
        "RayIoU@4": float(np.nanmean(ious[2])),
        "per_class": {OCC_CLASS_NAMES[i]: [float(ious[j][i])
                                           for j in range(3)]
                      for i in range(n_cls - 1)},
    }


def rayiou_from_outputs(sem_pred_list, sem_gt_list, origins_list,
                        pc_range: Sequence[float] = PC_RANGE,
                        voxel_size: float = VOXEL_SIZE,
                        device: Device = None) -> Dict[str, float]:
    """Full RayIoU pipeline over a dataset's outputs (ray_metrics.main):
    each sample's prediction and ground truth march together, every origin
    at once, in one call on ``device`` (default: the GPU; raises without
    one)."""
    device = resolve_device(device)
    rays = generate_lidar_rays()
    preds, gts = [], []
    for sp, sg, org in zip(sem_pred_list, sem_gt_list, origins_list):
        p, g = _march_grids([sp, sg], rays, org, pc_range, voxel_size,
                            device)
        preds.append(p)
        gts.append(g)
    return calc_rayiou(preds, gts)
