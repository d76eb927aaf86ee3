"""nuScenes infos dataset (the NuScenesDatasetBEVDet/Occupancy equivalent):
a copy of ``dhd_tpu/data/nuscenes.py``.

Consumes the same ``bevdetv2-nuscenes_infos_{train,val}.pkl`` files produced
by the reference's tools/create_data_bevdet.py (datasets/
nuscenes_dataset_bevdet.py:196-296, nuscenes_dataset_occ.py:40-65): infos
sorted by timestamp, per-sample ``curr`` record with cams/lidar/ego poses,
scene-boundary-clamped adjacent frames for temporal models, and the
``occ_path`` pointing at the Occ3D ``labels.npz`` directory.

No nuscenes-devkit / pyquaternion / mmcv dependency: quaternions are handled
in plain numpy.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

CAM_NAMES = (
    "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
    "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT",
)


def quat_to_rot(q: Sequence[float]) -> np.ndarray:
    """(w, x, y, z) unit quaternion -> 3x3 rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ], dtype=np.float64)


def pose_to_mat(rotation_quat, translation) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = quat_to_rot(rotation_quat)
    m[:3, 3] = np.asarray(translation, np.float64)
    return m


def load_lidar_points(path: str, load_dim: int = 5) -> np.ndarray:
    """nuScenes .bin lidar file -> (N, load_dim) float32."""
    pts = np.fromfile(path, dtype=np.float32)
    return pts.reshape(-1, load_dim)


class NuScenesOccDataset:
    """Info-pkl-backed dataset over occupancy samples."""

    def __init__(self, ann_file: str, data_root: str = "",
                 num_adj_frames: int = 0, stereo: bool = False,
                 load_interval: int = 1):
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        infos = sorted(data["infos"], key=lambda e: e["timestamp"])
        self.data_infos = infos[::load_interval]
        self.metadata = data.get("metadata", {})
        self.data_root = data_root
        self.num_adj_frames = num_adj_frames
        self.stereo = stereo

    def __len__(self) -> int:
        return len(self.data_infos)

    def get_adj_infos(self, index: int) -> List[dict]:
        """Previous-frame infos, clamped at scene boundaries; stereo models
        read one extra history frame (nuscenes_dataset_bevdet.py:280-296)."""
        info = self.data_infos[index]
        adj_ids = list(range(1, 1 + self.num_adj_frames))
        if self.stereo:
            adj_ids.append(1 + self.num_adj_frames)
        out = []
        for sel in adj_ids:
            sel = max(index - sel, 0)
            cand = self.data_infos[sel]
            out.append(cand if cand["scene_token"] == info["scene_token"]
                       else info)
        return out

    def get_sample(self, index: int) -> dict:
        info = self.data_infos[index]
        sample = {
            "token": info["token"],
            "curr": info,
            "occ_gt_path": info.get("occ_path"),
            "lidar_path": info.get("lidar_path"),
        }
        if self.num_adj_frames or self.stereo:
            sample["adjacent"] = self.get_adj_infos(index)
        return sample
