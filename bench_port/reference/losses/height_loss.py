"""Depth and height distribution supervision: counterpart of
``dhd_tpu/losses/height_loss.py`` (MGHS.get_height_loss /
get_downsampled_gt_{depth,height}, lss_heightmap.py:595-701).

Min-pool the sparse lidar-projected GT maps over ``downsample`` x
``downsample`` blocks ignoring zeros, bin them into shifted one-hots, and
take BCE between the predicted distribution (probabilities) and the
one-hot over the foreground pixels (those whose depth label is nonzero).
All fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from bench_port.reference.config import GridConfig
from bench_port.reference.parallel import global_sums


def downsample_min_nonzero(gt: torch.Tensor, ds: int) -> torch.Tensor:
    """Min-pool over ds x ds blocks treating 0.0 as missing.

    gt: (B, N, H, W) -> (B, N, H/ds, W/ds); an empty block gives 1e5, as in
    the reference, whose range check then drops it.
    """
    b, n, h, w = gt.shape
    x = torch.where(gt == 0.0, 1e5, gt)
    x = x.reshape(b, n, h // ds, ds, w // ds, ds)
    return x.amin(dim=(3, 5))


def shifted_onehot_labels(values: torch.Tensor, lower: float,
                          interval: float, num_bins: int,
                          shift_lower: bool) -> torch.Tensor:
    """Bin values into the reference's shifted one-hot labels.

    depth flavour (shift_lower=True):  idx = (v - (lower - interval))/interval
    height flavour (shift_lower=False): idx = (v - lower)/interval
    Kept if 0 <= idx < num_bins + 1, else forced to bin 0; one-hot over
    num_bins + 1 classes with the first column dropped, so a kept value in
    bin 0 gives an all-zero row (lss_heightmap.py:649-701).  fp32 out.
    """
    if shift_lower:
        idx = (values - (lower - interval)) / interval
    else:
        idx = (values - lower) / interval
    valid = (idx >= 0.0) & (idx < num_bins + 1)
    idx = torch.where(valid, idx, 0.0).to(torch.int64)
    return F.one_hot(idx, num_bins + 1)[..., 1:].float()


def bce_distribution_loss(pred_prob: torch.Tensor, labels: torch.Tensor,
                          fg_mask: torch.Tensor) -> torch.Tensor:
    """sum(BCE(pred, onehot)) over fg pixels / max(1, n_fg).

    pred_prob: (..., K) probabilities; labels: (..., K) in {0, 1};
    fg_mask: (...) bool.  Both logs are clamped at -100, as torch's
    ``F.binary_cross_entropy`` clamps them.
    """
    p = pred_prob.float()
    logp = torch.log(p).clamp(min=-100.0)
    log1mp = torch.log1p(-p).clamp(min=-100.0)
    bce = -(labels * logp + (1.0 - labels) * log1mp)
    fg = fg_mask.float()
    # over the global batch under a process group (losses/occ_loss.py)
    total, n_fg = global_sums((bce * fg[..., None]).sum(), fg.sum())
    return total / n_fg.clamp(min=1.0)


def depth_height_labels(gt_depth: torch.Tensor, gt_height: torch.Tensor,
                        downsample: int, gt_depth_grid: GridConfig,
                        frustum_d: int, height_min: float,
                        height_interval: float, num_height_bins: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The GT of both distributions: (depth_labels, height_labels, fg_mask).

    The depth binning uses the *mutated* 0.5 m interval the reference ends
    up with at loss time (``ViewTransformConfig.gt_depth``), while the
    number of label bins stays the frustum's D (lss_heightmap.py:663-666):
    for DHD-S 44 bins of 0.5 m, so the fg mask covers depths in [1, 23) m.
    """
    d_ds = downsample_min_nonzero(gt_depth, downsample)
    h_ds = downsample_min_nonzero(gt_height, downsample)
    d_labels = shifted_onehot_labels(
        d_ds, gt_depth_grid.lower, gt_depth_grid.interval, frustum_d,
        shift_lower=True)
    h_labels = shifted_onehot_labels(
        h_ds, height_min, height_interval, num_height_bins,
        shift_lower=False)
    fg_mask = d_labels.amax(dim=-1) > 0.0
    return d_labels, h_labels, fg_mask
