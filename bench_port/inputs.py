"""The benchmark's inputs, made from ``--seed``: a camera rig, served
frames and training batches with ground truth.

The geometry is a frozen copy of the port's ``data/synthetic.py`` (as it
stood when the benchmark was defined): six cameras on a level ring at
1.5 m looking outward, nuScenes-like intrinsics scaled to the input width,
and for training every camera and sample its own calibration and
augmentation (``vary_rig``), because on the plain ring a train-mode
BatchNorm of the camera embedding normalises rounding noise.  It is small
and made on the host in numpy.  Images and ground truth are large and are
made on the card by a ``torch.Generator`` there, in a few calls.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench_port.reference.config import ModelConfig


def _camera_ring(num_cams: int, rng: np.random.Generator) -> np.ndarray:
    """sensor2ego (N, 4, 4): cameras at ~1.5 m height on a ring, optical
    axis horizontal pointing outward (camera x right, y down, z forward)."""
    mats = []
    for i in range(num_cams):
        yaw = 2 * np.pi * i / num_cams + rng.normal(0, 0.02)
        f = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(f, up)
        right /= np.linalg.norm(right)
        down = np.cross(f, right)
        m = np.eye(4)
        m[:3, :3] = np.stack([right, down, f], axis=1)
        m[:3, 3] = [1.0 * np.cos(yaw), 1.0 * np.sin(yaw), 1.5]
        mats.append(m)
    return np.stack(mats).astype(np.float32)


def _rot(axis: int, angle: float) -> np.ndarray:
    """A 3x3 rotation by ``angle`` about axis 0, 1 or 2."""
    c, s = np.cos(angle), np.sin(angle)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m = np.eye(3)
    m[i, i] = m[j, j] = c
    m[i, j], m[j, i] = -s, s
    return m


def _intrinsics(cfg: ModelConfig, shape) -> np.ndarray:
    h, w = cfg.vt.input_size
    fx = 1266.0 * w / 1600.0
    intr = np.zeros(tuple(shape) + (3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = fx
    intr[..., 0, 2], intr[..., 1, 2], intr[..., 2, 2] = w / 2.0, h / 2.0, 1.0
    return intr


def rig(cfg: ModelConfig, seed: int) -> Dict[str, np.ndarray]:
    """One car's rig, B=1: sensor2ego (1, N, 4, 4), intrins, post_rots
    (1, N, 3, 3), post_trans (1, N, 3), bda (1, 3, 3); the ego at the
    origin (ego2global the identity)."""
    rng = np.random.default_rng(seed)
    n = cfg.num_cams
    return {"sensor2ego": _camera_ring(n, rng)[None],
            "ego2global": np.broadcast_to(np.eye(4, dtype=np.float32),
                                          (1, n, 4, 4)).copy(),
            "intrins": _intrinsics(cfg, (1, n)),
            "post_rots": np.broadcast_to(np.eye(3, dtype=np.float32),
                                         (1, n, 3, 3)).copy(),
            "post_trans": np.zeros((1, n, 3), np.float32),
            "bda": np.eye(3, dtype=np.float32)[None]}


def on_device(arrays: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def image_pool(cfg: ModelConfig, n: int, seed: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """``n`` image sets of one rig, (n, 1, N, H, W, 3) unit normals in
    ``dtype``, from one draw on ``device``."""
    h, w = cfg.vt.input_size
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, 1, cfg.num_cams, h, w, 3), generator=gen,
                       device=device).to(dtype)


def ego_poses(rig_: Dict[str, np.ndarray], n: int, step_m: float,
              device: torch.device) -> torch.Tensor:
    """ego2global of frames 0..n-1, (n, 1, N, 4, 4): the ego ``step_m``
    further along +x each frame."""
    base = torch.as_tensor(rig_["ego2global"], device=device)
    move = torch.zeros_like(base)
    move[..., 0, 3] = step_m
    k = torch.arange(n, dtype=torch.float32, device=device)
    return base[None] + k.view(n, 1, 1, 1, 1) * move[None]


def _vary_rig(cfg: ModelConfig, batch: dict, seed: int) -> dict:
    """``batch`` with the variety of a training batch, drawn from
    ``seed``: each camera its own intrinsics, mounting tilt and height, and
    image augmentation (scale, rotation, crop), each sample its own BEV
    augmentation (rotation, scale, flip)."""
    rng = np.random.default_rng(seed)
    b, n = batch["intrins"].shape[0], cfg.num_cams
    cams = (b, n)
    h, w = cfg.vt.input_size
    scale = rng.uniform(0.7, 1.3, cams + (2,))
    shift = rng.uniform(-0.2, 0.2, cams + (2,)) * (w, h)
    aug_s = rng.uniform(0.7, 1.3, cams)
    aug_r = rng.uniform(-0.3, 0.3, cams)
    aug_t = rng.uniform(-0.2, 0.2, cams + (2,)) * (w, h)
    tilt = [[_rot(0, rng.uniform(-0.3, 0.3)) @ _rot(1, rng.uniform(-0.3, 0.3))
             @ _rot(2, rng.uniform(-0.8, 0.8)) for _ in range(n)]
            for _ in range(b)]
    lift = rng.uniform(-0.3, 0.3, cams)
    bda = np.stack([
        _rot(2, rng.uniform(-np.pi, np.pi)) * rng.uniform(0.7, 1.3)
        @ np.diag([rng.choice([-1, 1]), rng.choice([-1, 1]), 1.0])
        for _ in range(b)])

    def per_cam(x, f):
        x = x.astype(np.float64).copy()
        for bi in range(b):
            for ni in range(n):
                if cfg.temporal:
                    x[bi, :, ni] = f(x[bi, :, ni], bi, ni)
                else:
                    x[bi, ni] = f(x[bi, ni], bi, ni)
        return x

    def intrinsics(m, bi, ni):
        m = m.copy()
        m[..., [0, 1], [0, 1]] *= scale[bi, ni]
        m[..., [0, 1], [2, 2]] += shift[bi, ni]
        return m

    def post_rot(m, bi, ni):
        r = _rot(2, aug_r[bi, ni]) * aug_s[bi, ni]
        r[2] = [0, 0, 1]
        return np.broadcast_to(r, m.shape)

    def post_tran(v, bi, ni):
        return np.broadcast_to(np.append(aug_t[bi, ni], 0.0), v.shape)

    def mount(m, bi, ni):
        m = m.copy()
        m[..., :3, :3] = m[..., :3, :3] @ tilt[bi][ni]
        m[..., 2, 3] += lift[bi, ni]
        return m
    out = dict(batch, bda=bda.astype(np.float32))
    out["intrins"] = per_cam(batch["intrins"], intrinsics).astype(np.float32)
    out["post_rots"] = per_cam(batch["post_rots"], post_rot).astype(
        np.float32)
    out["post_trans"] = per_cam(batch["post_trans"], post_tran).astype(
        np.float32)
    if cfg.temporal:
        s2e = per_cam(batch["sensor2ego"], mount)
        out["sensor2ego"] = s2e.astype(np.float32)
        e2g = batch["ego2global"].astype(np.float64)
        g2k = np.linalg.inv(e2g[:, 0, 0])[:, None, None]
        out["sensor2keyego"] = (g2k @ e2g @ s2e).astype(np.float32)
        c2g = e2g @ s2e
        out["curr2adjsensor"] = (np.linalg.inv(c2g[:, 1:])
                                 @ c2g[:, :-1]).astype(np.float32)
    else:
        out["sensor2keyego"] = per_cam(batch["sensor2keyego"],
                                       mount).astype(np.float32)
    return out


def train_geometry(cfg: ModelConfig, batch_size: int, seed: int
                   ) -> Dict[str, np.ndarray]:
    """The geometry of one training batch: a ring per sample, for a
    temporal model frames-major (B, F, N, ...) with the ego 0.5 m further
    back each older frame, then :func:`_vary_rig`."""
    rng = np.random.default_rng(seed)
    n = cfg.num_cams
    ring = np.stack([_camera_ring(n, rng) for _ in range(batch_size)])
    if cfg.temporal:
        f = cfg.num_frames
        s2e = np.broadcast_to(ring[:, None], (batch_size, f, n, 4, 4)).copy()
        e2g = np.zeros((batch_size, f, n, 4, 4), np.float32)
        for fi in range(f):
            e2g[:, fi] = np.eye(4, dtype=np.float32)
            e2g[:, fi, :, 0, 3] = -0.5 * fi
        view = (batch_size, f, n)
    else:
        s2e = ring
        e2g = np.broadcast_to(np.eye(4, dtype=np.float32),
                              (batch_size, n, 4, 4)).copy()
        view = (batch_size, n)
    batch = {"intrins": _intrinsics(cfg, view),
             "post_rots": np.broadcast_to(np.eye(3, dtype=np.float32),
                                          view + (3, 3)).copy(),
             "post_trans": np.zeros(view + (3,), np.float32),
             "bda": np.broadcast_to(np.eye(3, dtype=np.float32),
                                    (batch_size, 3, 3)).copy(),
             "sensor2ego": s2e, "ego2global": e2g}
    if not cfg.temporal:
        batch["sensor2keyego"] = s2e
    return _vary_rig(cfg, batch, seed + 100)


def train_batch(cfg: ModelConfig, batch_size: int, seed: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """One training batch on ``device``: the geometry of
    :func:`train_geometry`, fp32 unit-normal images, and ground truth
    drawn as the port's synthetic batches draw it (free voxels, the rest
    of a uniform class, a camera mask; depth and height on sparse pixels)
    but with shares of each sample's own, as scenes differ: free space
    over 60–95% of the voxels, the camera mask over 30–90%, depth on
    1–4% of the pixels."""
    out = on_device(train_geometry(cfg, batch_size, seed), device)
    gen = torch.Generator(device=device).manual_seed(seed)
    h, w = cfg.vt.input_size
    n = cfg.num_cams
    lead = ((batch_size, cfg.num_frames) if cfg.temporal else (batch_size,))
    out["imgs"] = torch.randn(lead + (n, h, w, 3), generator=gen,
                              device=device)
    free_s, cam_s, depth_s = (
        lo + (hi - lo) * torch.rand((batch_size,), generator=gen,
                                    device=device)
        for lo, hi in ((0.6, 0.95), (0.3, 0.9), (0.01, 0.04)))
    vox = (batch_size, cfg.vt.x.size, cfg.vt.y.size, cfg.vt.z_fine.size)
    per_vox = (batch_size, 1, 1, 1)
    sem = torch.randint(0, cfg.num_classes, vox, generator=gen,
                        device=device, dtype=torch.int32)
    free = torch.rand(vox, generator=gen, device=device) < free_s.view(
        per_vox)
    out["voxel_semantics"] = torch.where(free, cfg.num_classes - 1, sem)
    out["mask_camera"] = (torch.rand(vox, generator=gen, device=device)
                          < cam_s.view(per_vox)).to(torch.int32)
    px = (batch_size, n, h, w)
    u = torch.rand((3,) + px, generator=gen, device=device)
    sparse = u[0] < depth_s.view(batch_size, 1, 1, 1)
    out["gt_depth"] = torch.where(sparse, 60.0 * u[1], 0.0)
    out["gt_height"] = torch.where(sparse, -2.0 + 8.0 * u[2], 0.0)
    return out
