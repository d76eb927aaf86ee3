"""Occ3D mIoU metric (core/evaluation/occ_metrics.py:52-169): counterpart of
``dhd_tpu/eval/miou.py``.

An 18x18 confusion matrix over camera-visible voxels, counted on the
predictions' device with ``torch.bincount`` (exact int64 counts, one
18x18 copy to the host per batch); per-class IoU = diag / (row + col -
diag); the headline mIoU averages classes 0..16 (free excluded).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from dhd_tpu_torch.config import OCC_CLASS_NAMES


def _on(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device)


def confusion_matrix(pred, gt, mask, num_classes: int = 18) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts of (gt, pred) pairs where
    ``mask`` is nonzero, on ``pred``'s device (numpy inputs: the CPU).  A
    pair whose flat index ``gt * num_classes + pred`` falls outside the
    matrix is dropped, as JAX's ``segment_sum`` drops it."""
    if not torch.is_tensor(pred):
        pred = torch.from_numpy(np.asarray(pred))
    dev = pred.device
    nn = num_classes * num_classes
    idx = (_on(gt, dev).reshape(-1).long() * num_classes
           + pred.reshape(-1).long())
    keep = (_on(mask, dev).reshape(-1) != 0) & (idx >= 0) & (idx < nn)
    # dropped pairs go to one extra bin, so nothing waits on a nonzero()
    idx = torch.where(keep, idx, nn)
    return torch.bincount(idx, minlength=nn + 1)[:nn].reshape(
        num_classes, num_classes)


def miou_from_confusion(cm: np.ndarray, num_eval_classes: int = 17
                        ) -> Tuple[float, Dict[str, float]]:
    cm = np.asarray(cm, np.float64)
    diag = np.diag(cm)
    denom = cm.sum(0) + cm.sum(1) - diag
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = diag / denom
    per_class = {OCC_CLASS_NAMES[i]: float(iou[i]) for i in range(len(diag))}
    valid = iou[:num_eval_classes]
    miou = float(np.nanmean(valid))
    return miou, per_class


class MIoUMetric:
    """Streaming accumulator mirroring Metric_mIoU(use_image_mask=True)."""

    def __init__(self, num_classes: int = 18, num_eval_classes: int = 17):
        self.num_classes = num_classes
        self.num_eval_classes = num_eval_classes
        self.cm = np.zeros((num_classes, num_classes), np.int64)
        self.count = 0

    def add_batch(self, pred, gt, mask) -> None:
        """Count a batch: ``pred`` (B, Dx, Dy, Dz) class ids, a tensor on
        any device (the GT and mask are copied there) or numpy."""
        self.cm += confusion_matrix(pred, gt, mask,
                                    self.num_classes).cpu().numpy()
        self.count += int(pred.shape[0])

    def compute(self) -> Tuple[float, Dict[str, float]]:
        return miou_from_confusion(self.cm, self.num_eval_classes)

    def summary(self) -> str:
        miou, per_class = self.compute()
        lines = [f"===> per class IoU of {self.count} samples:"]
        for name in OCC_CLASS_NAMES[:self.num_eval_classes]:
            lines.append(f"===> {name:24s} IoU = {per_class[name]*100:.2f}")
        lines.append(f"===> mIoU: {miou*100:.2f}")
        return "\n".join(lines)
