"""Cancellation-free rigid-transform (SE3) composition: counterpart of
``dhd_tpu/geometry/rigid.py``.

nuScenes ego2global translations are O(1000 m).  A plain fp32
``inv(a) @ b`` of two nearby global poses materialises a ``-R^T t`` term of
that size before the cancellation and loses centimetres.  For rigid
transforms

    inv(A) @ B = [Ra^T Rb | Ra^T (tb - ta)]

and ``tb - ta`` is formed first: the large near-equal components cancel
exactly, so the result is accurate to the ulp of the relative motion.
Also a closed-form 3x3 inverse for the per-frame geometry.
"""
from __future__ import annotations

import torch


def rigid_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid 4x4 transforms, ``[R | t]^-1 = [R^T | -R^T t]``,
    over any leading batch dims."""
    rt = a[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", rt, a[..., :3, 3])
    return _compose(rt, ti)


def rigid_relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``inv(a) @ b`` for rigid transforms, with ``tb - ta`` formed before
    any rotation touches the large values."""
    rat = a[..., :3, :3].transpose(-1, -2)
    r = torch.einsum("...ij,...jk->...ik", rat, b[..., :3, :3])
    t = torch.einsum("...ij,...j->...i", rat, b[..., :3, 3] - a[..., :3, 3])
    return _compose(r, t)


def inverse_3x3(m: torch.Tensor) -> torch.Tensor:
    """Inverse of 3x3 matrices over any leading batch dims, in closed form
    (adjugate over determinant).  Elementwise ops only: on a GPU it does not
    wait for the device, as ``torch.linalg.inv``'s error check does."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    adj = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                       f * g - d * i, a * i - c * g, c * d - a * f,
                       d * h - e * g, b * g - a * h, a * e - b * d],
                      dim=-1).reshape(m.shape)
    det = a * adj[..., 0, 0] + b * adj[..., 1, 0] + c * adj[..., 2, 0]
    return adj / det[..., None, None]


def _compose(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(r.shape[:-2] + (4, 4), dtype=r.dtype, device=r.device)
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out
