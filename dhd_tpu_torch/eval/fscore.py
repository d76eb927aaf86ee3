"""Chamfer-style F-score metric (core/evaluation/occ_metrics.py:172-260): a
copy of ``dhd_tpu/eval/fscore.py``.

Occupied voxels (non-void) become center points; completeness = fraction of
GT points within 0.6 m of a prediction, accuracy = the converse, F-score =
their harmonic mean, averaged over samples.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree

PC_RANGE = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
VOXEL_SIZE = (0.4, 0.4, 0.4)


def voxel2points(voxel: np.ndarray, void: Sequence[int] = (17, 255),
                 voxel_size=VOXEL_SIZE, pc_range=PC_RANGE) -> np.ndarray:
    mask = ~np.isin(voxel, list(void))
    idx = np.where(mask)
    return np.stack(
        [idx[d] * voxel_size[d] + voxel_size[d] / 2 + pc_range[d]
         for d in range(3)], axis=1).astype(np.float64)


class FScoreMetric:
    def __init__(self, threshold_acc: float = 0.6,
                 threshold_complete: float = 0.6,
                 use_image_mask: bool = True,
                 use_lidar_mask: bool = False):
        self.threshold_acc = threshold_acc
        self.threshold_complete = threshold_complete
        self.use_image_mask = use_image_mask
        self.use_lidar_mask = use_lidar_mask
        self.cnt = 0
        self.tot_acc = 0.0
        self.tot_cmpl = 0.0
        self.tot_f1 = 0.0
        self.eps = 1e-8

    def add_batch(self, pred: np.ndarray, gt: np.ndarray,
                  mask_lidar: np.ndarray, mask_camera: np.ndarray) -> None:
        """Single-sample (Dx, Dy, Dz) grids (call per sample, like the
        reference)."""
        pred = np.array(pred, copy=True)
        gt = np.array(gt, copy=True)
        if self.use_image_mask:
            pred[mask_camera == 0] = 255
            gt[mask_camera == 0] = 255
        elif self.use_lidar_mask:
            pred[mask_lidar == 0] = 255
            gt[mask_lidar == 0] = 255
        self.cnt += 1
        gt_pts = voxel2points(gt)
        pr_pts = voxel2points(pred)
        if pr_pts.shape[0] == 0 or gt_pts.shape[0] == 0:
            return
        dist_cmpl, _ = cKDTree(pr_pts).query(gt_pts)
        dist_acc, _ = cKDTree(gt_pts).query(pr_pts)
        completeness = float((dist_cmpl < self.threshold_complete).mean())
        accuracy = float((dist_acc < self.threshold_acc).mean())
        f1 = 2.0 / (1.0 / (accuracy + self.eps)
                    + 1.0 / (completeness + self.eps))
        self.tot_acc += accuracy
        self.tot_cmpl += completeness
        self.tot_f1 += f1

    def compute(self) -> Tuple[float, float, float]:
        n = max(self.cnt, 1)
        return (self.tot_f1 / n, self.tot_acc / n, self.tot_cmpl / n)
