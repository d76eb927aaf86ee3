"""The train and eval steps: counterpart of ``dhd_tpu/train/step.py``.

One :func:`train_step` is the reference's whole train iteration
(EpochBasedRunner.train -> DHD.forward_train -> backward -> grad clip ->
AdamW -> MEGVIIEMAHook; SURVEY.md §3.1) on one device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from dhd_tpu_torch.config import ModelConfig, class_weights
from dhd_tpu_torch.device import device_constant
from dhd_tpu_torch.losses import (bce_distribution_loss, depth_height_labels,
                                  occ_losses_fused, occ_losses_fused_packed)
from dhd_tpu_torch.parallel.mesh import all_reduce_gradients
from dhd_tpu_torch.train.ema import ModelEMA
from dhd_tpu_torch.train.optim import AdamWSchedule

GT_KEYS = ("gt_depth", "gt_height", "voxel_semantics", "mask_camera")


def _gt(batch: Dict[str, Any], device: torch.device
        ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k], device=device) for k in GT_KEYS}


def total_loss(cfg: ModelConfig, out: Dict[str, torch.Tensor],
               batch: Dict[str, Any]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The DHD loss dict (DHD_model.py:135-205, occ_head.py:102-139):
    loss_height (+ loss_depth for a full depth net) + weight_ce * CE +
    weight_sem * sem_scal + weight_geo * geo_scal, and their sum
    ``loss_total``.  ``batch`` holds the ground truth (numpy arrays or
    tensors): gt_depth, gt_height (B, N, H, W); voxel_semantics,
    mask_camera (B, Dx, Dy, Dz).  Returns (loss_total, dict)."""
    lc, vt = cfg.loss, cfg.vt
    dev = out["height"].device
    gt = _gt(batch, dev)
    d_labels, h_labels, fg = depth_height_labels(
        gt["gt_depth"].float(), gt["gt_height"].float(), vt.downsample,
        vt.gt_depth, vt.D, vt.height_min, vt.height_interval,
        vt.num_height_bins)
    losses = {"loss_height": lc.loss_height_weight * bce_distribution_loss(
        out["height"], h_labels, fg)}
    if cfg.depth_net == "full":
        losses["loss_depth"] = lc.loss_depth_weight * bce_distribution_loss(
            out["depth"], d_labels, fg)
    cw = device_constant(class_weights(lc.num_classes), dev)
    if "occ_logits_flat" in out:
        l_ce, l_geo, l_sem = occ_losses_fused_packed(
            out["occ_logits_flat"], gt["voxel_semantics"],
            gt["mask_camera"], cw, lc.num_classes, lc.free_class)
    else:
        l_ce, l_geo, l_sem = occ_losses_fused(
            out["occ_logits"], gt["voxel_semantics"], gt["mask_camera"],
            cw, lc.free_class)
    losses["loss_occ"] = lc.weight_ce * l_ce
    losses["loss_voxel_sem_scal"] = lc.weight_sem * l_sem
    losses["loss_voxel_geo_scal"] = lc.weight_geo * l_geo
    total = sum(losses.values())
    losses["loss_total"] = total
    return total, losses


def train_step(model: nn.Module, optimizer: AdamWSchedule,
               ema: Optional[ModelEMA], batch: Dict[str, Any],
               generator: Optional[torch.Generator] = None,
               with_prev: bool = True,
               compute_dtype: Optional[torch.dtype] = None
               ) -> Dict[str, torch.Tensor]:
    """One training iteration of ``model`` (put in train mode) on
    ``batch`` (model inputs and ground truth): the forward, the losses,
    the backward, the clipped AdamW step, and the EMA update.

    ``generator`` draws the dropout and DropPath masks (on the model's
    device).  ``with_prev=False`` is the early-epoch forward of a temporal
    model (ignored by a single-frame one).  ``compute_dtype``
    ``torch.bfloat16`` is mixed precision, the JAX CLIs' ``--bf16``: the
    forward in bf16 (``DHDNet.computing_in``) over the fp32 weights, the
    losses, gradients, AdamW moments, running statistics and EMA in fp32.
    Returns the loss dict and ``grad_norm``, the gradients' global norm
    before clipping, as 0-dim tensors: nothing is read back to the host.

    Under a process group each process passes its rows of the global
    batch; the BatchNorms and the losses sum over the global batch and the
    gradients are averaged after the backward, so every process takes the
    one-process step over the global batch
    (:mod:`dhd_tpu_torch.parallel.mesh`).
    """
    cfg = model.cfg
    model.train()
    optimizer.zero_grad()
    extra = {"with_prev": with_prev} if cfg.temporal else {}
    with model.computing_in(compute_dtype):
        out = model(batch, generator=generator, **extra)
    loss, metrics = total_loss(cfg, out, batch)
    loss.backward()
    all_reduce_gradients(model.parameters())
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = optimizer.step()
    if ema is not None:
        ema.update(model)
    return metrics


@torch.no_grad()
def eval_step(model: nn.Module, batch: Dict[str, Any],
              ema: Optional[ModelEMA] = None, use_ema: bool = False
              ) -> torch.Tensor:
    """The predicted class grid (B, Dx, Dy, Dz) uint8: argmax of
    ``occ_logits`` (occ_head.get_occ, occ_head.py:141-153), in eval mode,
    with the EMA's weights when ``use_ema`` and an EMA is given."""
    model.eval()
    if use_ema and ema is not None:
        with ema.applied(model):
            out = model(batch)
    else:
        out = model(batch)
    return out["occ_logits"].argmax(dim=-1).to(torch.uint8)
