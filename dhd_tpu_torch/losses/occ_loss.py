"""Occupancy losses: class-balanced CE and the geometric / semantic scal
losses, counterpart of ``dhd_tpu/losses/occ_loss.py``.

* :func:`occ_ce_loss`   -- mmdet CrossEntropyLoss with class_weight, sample
  weight = camera mask, avg_factor = the summed class weights of the
  visible voxels (occ_head.py:102-139);
* :func:`geo_scal_loss` -- occupied-vs-free precision / recall /
  specificity (losses/semkitti_loss.py:136-168);
* :func:`sem_scal_loss` -- per-class precision / recall / specificity
  (losses/semkitti_loss.py:170-226);
* :func:`occ_losses_fused` / :func:`occ_losses_fused_packed` -- all three
  from one log-softmax, what the train step runs.

The reference's ``inverse_sigmoid`` + BCE-with-logits(x, 1) composition is
-log(clip(x, 1e-5, 1 - 1e-5)) (:func:`_neg_log`); masks multiply instead of
indexing.  The JAX package's packed-lane layout rules (the ``@ expand``
broadcasts) are TPU rules: here the packed logits are viewed as
(V, Dz, n_cls) and take one ``log_softmax``.  All fp32.

Every loss is a ratio of sums over the batch.  Under a process group the
sums are taken over the global batch (``parallel.global_sums``) before
the ratios, as the JAX package's losses over a sharded batch are.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from dhd_tpu_torch.device import device_constant
from dhd_tpu_torch.parallel.mesh import global_sums

_EPS = 1e-5


def _neg_log(x: torch.Tensor) -> torch.Tensor:
    """-log(x) clipped to [1e-5, 1 - 1e-5] first, so it stays finite and
    so does its gradient (zero where clipped)."""
    return -torch.log(x.clamp(_EPS, 1.0 - _EPS))


def occ_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, class_weight: torch.Tensor
                ) -> torch.Tensor:
    """Weighted softmax CE over the visible voxels.

    logits (..., n_cls); labels (...) int; mask (...) in {0, 1};
    class_weight (n_cls,).  Returns sum(w_label * CE * mask) /
    sum(w_label * mask).
    """
    logits = logits.reshape(-1, logits.shape[-1]).float()
    labels = labels.reshape(-1).long()
    mask = mask.reshape(-1).float()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(1, labels[:, None])[:, 0]
    w = class_weight[labels] * mask
    num, den = global_sums((ce * w).sum(), w.sum())
    return num / den.clamp(min=1e-6)


def geo_scal_loss(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, free_class: int = 17) -> torch.Tensor:
    """-log of the precision, recall and specificity of occupied vs free."""
    probs = torch.softmax(logits.reshape(-1, logits.shape[-1]).float(), -1)
    labels = labels.reshape(-1)
    mask = mask.reshape(-1).float()
    empty_p = probs[:, free_class]
    nonempty_p = 1.0 - empty_p
    nonempty_t = (labels != free_class).float() * mask
    empty_t = (labels == free_class).float() * mask
    inter, sum_p, sum_t, inter_e, sum_e = global_sums(
        (nonempty_t * nonempty_p).sum(), (nonempty_p * mask).sum(),
        nonempty_t.sum(), (empty_t * empty_p).sum(), empty_t.sum())
    precision = inter / (sum_p + _EPS)
    recall = inter / (sum_t + _EPS)
    spec = inter_e / (sum_e + _EPS)
    return _neg_log(precision) + _neg_log(recall) + _neg_log(spec)


def _scal_terms(sum_t: torch.Tensor, sum_p: torch.Tensor,
                inter: torch.Tensor, n_masked: torch.Tensor,
                skip_class: int) -> torch.Tensor:
    """The semantic scal loss from per-class target, prediction and
    intersection sums: each class's -log precision / recall / specificity
    where the reference adds them (sum_p, sum_t, spec_den > 0), averaged
    over the classes present but ``skip_class``; 0 if none is."""
    spec_num = n_masked - sum_p - sum_t + inter
    spec_den = n_masked - sum_t
    zero = sum_t.new_zeros(())
    loss_c = (torch.where(sum_p > 0, _neg_log(inter / (sum_p + _EPS)), zero)
              + torch.where(sum_t > 0, _neg_log(inter / (sum_t + _EPS)),
                            zero)
              + torch.where(spec_den > 0,
                            _neg_log(spec_num / (spec_den + _EPS)), zero))
    keep = device_constant([float(c != skip_class)
                            for c in range(sum_t.numel())], sum_t.device)
    present = (sum_t > 0).float() * keep
    count = present.sum()
    return torch.where(count > 0, (loss_c * present).sum()
                       / count.clamp(min=1.0), zero)


def sem_scal_loss(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Per-class precision / recall / specificity, averaged over the
    classes present; the last (free) class is skipped."""
    n_cls = logits.shape[-1]
    probs = torch.softmax(logits.reshape(-1, n_cls).float(), dim=-1)
    mask = mask.reshape(-1).float()
    onehot = F.one_hot(labels.reshape(-1).long(), n_cls).float() \
        * mask[:, None]
    return _scal_terms(*global_sums(
        onehot.sum(0), (probs * mask[:, None]).sum(0),
        (probs * onehot).sum(0), mask.sum()), n_cls - 1)


def occ_losses_fused(logits: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor, class_weight: torch.Tensor,
                     free_class: int = 17
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(CE, geo_scal, sem_scal) from one log-softmax of (..., n_cls)
    logits: the formulas of :func:`occ_ce_loss`, :func:`geo_scal_loss` and
    :func:`sem_scal_loss` (with ``free_class`` skipped)."""
    n_cls = logits.shape[-1]
    return occ_losses_fused_packed(logits.reshape(-1, n_cls), labels,
                                   mask, class_weight, n_cls, free_class)


def occ_losses_fused_packed(flat_logits: torch.Tensor, labels: torch.Tensor,
                            mask: torch.Tensor, class_weight: torch.Tensor,
                            n_cls: int, free_class: int = 17
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """:func:`occ_losses_fused` on packed (..., Dz * n_cls) logits (the
    occupancy head's ``occ_logits_flat``); labels and mask (..., Dz)."""
    x = flat_logits.reshape(-1, n_cls).float()           # (V * Dz, n_cls)
    labels = labels.reshape(-1).long()
    mask = mask.reshape(-1).float()
    logp = torch.log_softmax(x, dim=-1)
    w = class_weight[labels] * mask
    ce = -logp.gather(1, labels[:, None])[:, 0]
    pm = logp.exp() * mask[:, None]
    onehot = F.one_hot(labels, n_cls).float()
    ce_w, w_sum, sum_t, sum_p, inter, n_masked = global_sums(
        (ce * w).sum(), w.sum(),
        (onehot * mask[:, None]).sum(0),                  # (n_cls,)
        pm.sum(0), (pm * onehot).sum(0), mask.sum())
    loss_ce = ce_w / w_sum.clamp(min=1e-6)

    f = free_class
    g_inter = n_masked - sum_t[f] - sum_p[f] + inter[f]
    loss_geo = (_neg_log(g_inter / (n_masked - sum_p[f] + _EPS))
                + _neg_log(g_inter / (n_masked - sum_t[f] + _EPS))
                + _neg_log(inter[f] / (sum_t[f] + _EPS)))
    loss_sem = _scal_terms(sum_t, sum_p, inter, n_masked, f)
    return loss_ce, loss_geo, loss_sem
