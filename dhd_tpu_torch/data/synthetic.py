"""Synthetic nuScenes-like batches for tests and benchmarking.

Generates plausible 6-camera geometry (cameras on a ring looking outward,
nuScenes-like intrinsics scaled to the input size) plus random images and
voxel GT, so the full model + losses can run without the dataset.  A copy
of ``dhd_tpu/data/synthetic.py``: the same seed gives the same numpy arrays
in both packages (``varied_rig``, for comparing training steps, is the
port's own).
"""
from __future__ import annotations

import numpy as np

from dhd_tpu_torch.config import ModelConfig


def _camera_ring(num_cams: int, rng: np.random.Generator) -> np.ndarray:
    """sensor2ego (N, 4, 4): cameras at ~1.5 m height on a ring, optical axis
    horizontal pointing outward.  Camera frame: x right, y down, z forward."""
    mats = []
    for i in range(num_cams):
        yaw = 2 * np.pi * i / num_cams + rng.normal(0, 0.02)
        # ego-frame forward direction of the optical axis
        f = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(f, up)
        right /= np.linalg.norm(right)
        down = np.cross(f, right)
        # columns are the camera axes (x=right, y=down, z=forward) in ego
        r = np.stack([right, down, f], axis=1)
        t = np.array([1.0 * np.cos(yaw), 1.0 * np.sin(yaw), 1.5])
        m = np.eye(4)
        m[:3, :3] = r
        m[:3, 3] = t
        mats.append(m)
    return np.stack(mats).astype(np.float32)


def _ego_pose(dist: float) -> np.ndarray:
    """ego2global for an ego that has driven ``dist`` m along +x."""
    m = np.eye(4, dtype=np.float32)
    m[0, 3] = dist
    return m


def _rot(axis: int, angle: float) -> np.ndarray:
    """A 3x3 rotation by ``angle`` about axis 0, 1 or 2."""
    c, s = np.cos(angle), np.sin(angle)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m = np.eye(3)
    m[i, i] = m[j, j] = c
    m[i, j], m[j, i] = -s, s
    return m


def _vary_rig(cfg: ModelConfig, batch: dict, seed: int) -> dict:
    """``batch`` with the variety of a training batch, drawn from
    ``seed``: each camera its own intrinsics, mounting tilt and height, and
    image augmentation (scale, rotation, crop), each sample its own BEV
    augmentation (rotation, scale, flip)."""
    rng = np.random.default_rng(seed)
    b, n = batch["imgs"].shape[0], cfg.num_cams
    cams = (b, n)
    intr = batch["intrins"].astype(np.float64)
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
        """Apply ``f(x[bi, ni], bi, ni)`` to every camera, across frames."""
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
    out["intrins"] = per_cam(intr, intrinsics).astype(np.float32)
    out["post_rots"] = per_cam(batch["post_rots"], post_rot).astype(
        np.float32)
    out["post_trans"] = per_cam(batch["post_trans"], post_tran).astype(
        np.float32)
    if cfg.temporal:
        s2e = per_cam(batch["sensor2ego"], mount)
        out["sensor2ego"] = s2e.astype(np.float32)
        # the host-fp64 compositions, as synthetic_batch makes them
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


def synthetic_batch(cfg: ModelConfig, batch_size: int = 1, seed: int = 0,
                    with_gt: bool = True, varied_rig: bool = False) -> dict:
    """Build a model-input batch (plus GT when ``with_gt``) of numpy arrays.

    Single-frame models get (B, N, ...) tensors; temporal models get the
    frames-major (B, F, N, ...) layout with a small forward ego motion
    between frames (newest first: frame 0 = key).

    ``varied_rig`` gives every camera and sample its own calibration and
    augmentation (:func:`_vary_rig`, from ``seed + 100``).  The plain rig's
    six identical cameras on a level ring give 21 of the 27
    camera-embedding features one value in every row, where a train-mode
    BatchNorm normalises rounding noise, on which two implementations (or
    GPU and CPU) cannot agree: a batch that two training steps are
    compared on varies the rig.
    """
    rng = np.random.default_rng(seed)
    n = cfg.num_cams
    h, w = cfg.vt.input_size
    dx, dy, dz = cfg.vt.x.size, cfg.vt.y.size, cfg.vt.z_fine.size

    if cfg.temporal:
        f = cfg.num_frames
        imgs = rng.normal(0, 1, (batch_size, f, n, h, w, 3)).astype(np.float32)
        ring = np.stack([_camera_ring(n, rng) for _ in range(batch_size)])
        s2e = np.broadcast_to(ring[:, None], (batch_size, f, n, 4, 4)).copy()
        e2g = np.zeros((batch_size, f, n, 4, 4), np.float32)
        for fi in range(f):
            e2g[:, fi] = _ego_pose(-0.5 * fi)     # older frames further back
    else:
        imgs = rng.normal(0, 1, (batch_size, n, h, w, 3)).astype(np.float32)
        s2e = np.stack([_camera_ring(n, rng) for _ in range(batch_size)])
        e2g = np.broadcast_to(np.eye(4, dtype=np.float32),
                              (batch_size, n, 4, 4)).copy()
    # nuScenes-ish intrinsics (fx ~ 1266 at 1600 px) scaled to input width.
    view_shape = s2e.shape[:-2]
    fx = 1266.0 * w / 1600.0
    intr = np.zeros(view_shape + (3, 3), np.float32)
    intr[..., 0, 0] = fx
    intr[..., 1, 1] = fx
    intr[..., 0, 2] = w / 2.0
    intr[..., 1, 2] = h / 2.0
    intr[..., 2, 2] = 1.0
    post_rots = np.broadcast_to(np.eye(3, dtype=np.float32),
                                view_shape + (3, 3)).copy()
    post_trans = np.zeros(view_shape + (3,), np.float32)
    bda = np.broadcast_to(np.eye(3, dtype=np.float32),
                          (batch_size, 3, 3)).copy()

    batch = {
        "imgs": imgs,
        "intrins": intr,
        "post_rots": post_rots,
        "post_trans": post_trans,
        "bda": bda,
    }
    if cfg.temporal:
        batch["sensor2ego"] = s2e
        batch["ego2global"] = e2g
        # host-side float64 key-ego / adjacent-sensor compositions, matching
        # the real pipeline (the reference's .double(), bevdet.py:72-74)
        s2e64 = s2e.astype(np.float64)
        e2g64 = e2g.astype(np.float64)
        g2k = np.linalg.inv(e2g64[:, 0, 0])[:, None, None]
        batch["sensor2keyego"] = (g2k @ e2g64 @ s2e64).astype(np.float32)
        cam2glob = e2g64 @ s2e64
        batch["curr2adjsensor"] = (
            np.linalg.inv(cam2glob[:, 1:]) @ cam2glob[:, :-1]
        ).astype(np.float32)
    else:
        batch["sensor2keyego"] = s2e
        batch["ego2global"] = e2g
    if with_gt:
        n_cls = cfg.num_classes
        sem = rng.integers(0, n_cls, (batch_size, dx, dy, dz))
        # mostly free space, like real Occ3D GT
        free = rng.random((batch_size, dx, dy, dz)) < 0.8
        sem = np.where(free, n_cls - 1, sem).astype(np.int32)
        batch["voxel_semantics"] = sem
        batch["mask_camera"] = (
            rng.random((batch_size, dx, dy, dz)) < 0.6).astype(np.int32)
        depth = rng.uniform(0.0, 60.0, (batch_size, n, h, w))
        sparse = rng.random((batch_size, n, h, w)) < 0.02
        batch["gt_depth"] = np.where(sparse, depth, 0.0).astype(np.float32)
        height = rng.uniform(-2.0, 6.0, (batch_size, n, h, w))
        batch["gt_height"] = np.where(sparse, height, 0.0).astype(np.float32)
    return _vary_rig(cfg, batch, seed + 100) if varied_rig else batch
