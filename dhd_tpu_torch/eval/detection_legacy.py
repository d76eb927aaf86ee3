"""Detection-legacy utilities kept for BEVDet-checkpoint compatibility.

The reference carries a CenterPoint bbox coder and rotated BEV NMS
(core/bbox/coders/centerpoint_bbox_coders.py:9, core/post_processing/
box3d_nms.py:11) that are *not used on the occupancy path* (SURVEY.md §1);
they exist so BEVDet detection checkpoints/configs keep working.  These are
compact numpy re-derivations with the same semantics, copied from
``dhd_tpu/eval/detection_legacy.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _rect_corners(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) [cx, cy, w, h, yaw] -> (N, 4, 2) corner polygons (ccw)."""
    cx, cy, w, h, yaw = boxes.T
    cos, sin = np.cos(yaw), np.sin(yaw)
    dx = np.stack([w / 2, -w / 2, -w / 2, w / 2], 1)
    dy = np.stack([h / 2, h / 2, -h / 2, -h / 2], 1)
    x = cx[:, None] + dx * cos[:, None] - dy * sin[:, None]
    y = cy[:, None] + dx * sin[:, None] + dy * cos[:, None]
    return np.stack([x, y], axis=-1)


def _poly_area(p: np.ndarray) -> float:
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip_poly(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman convex polygon intersection."""
    out = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        edge = b - a
        inp, out = out, []
        if not inp:
            break

        def inside(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= 0

        def intersect(p, q):
            d = q - p
            denom = edge[0] * d[1] - edge[1] * d[0]
            if abs(denom) < 1e-12:
                return q
            t = (edge[0] * (a[1] - p[1]) - edge[1] * (a[0] - p[0])) / denom
            return p + t * d

        for j in range(len(inp)):
            cur, nxt = inp[j], inp[(j + 1) % len(inp)]
            if inside(cur):
                out.append(cur)
                if not inside(nxt):
                    out.append(intersect(cur, nxt))
            elif inside(nxt):
                out.append(intersect(cur, nxt))
    return np.asarray(out) if out else np.zeros((0, 2))


def rotated_iou_bev(box_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """IoU of one rotated BEV box vs many ([cx, cy, w, h, yaw])."""
    pa = _rect_corners(box_a[None])[0]
    pbs = _rect_corners(boxes_b)
    area_a = box_a[2] * box_a[3]
    out = np.zeros(len(boxes_b))
    for i, pb in enumerate(pbs):
        inter_poly = _clip_poly(pa, pb)
        inter = _poly_area(inter_poly) if len(inter_poly) >= 3 else 0.0
        area_b = boxes_b[i, 2] * boxes_b[i, 3]
        union = area_a + area_b - inter
        out[i] = inter / union if union > 0 else 0.0
    return out


def nms_bev(boxes: np.ndarray, scores: np.ndarray, thresh: float,
            pre_max_size: Optional[int] = None,
            post_max_size: Optional[int] = None) -> np.ndarray:
    """Rotated BEV NMS (box3d_nms.py:11 semantics).

    boxes: (N, 5) [cx, cy, w, h, yaw]; returns kept indices sorted by score.
    """
    order = np.argsort(-scores)
    if pre_max_size is not None:
        order = order[:pre_max_size]
    keep: List[int] = []
    suppressed = np.zeros(len(order), bool)
    for i in range(len(order)):
        if suppressed[i]:
            continue
        keep.append(order[i])
        if i + 1 < len(order):
            rest = order[i + 1:]
            live = ~suppressed[i + 1:]
            if live.any():
                ious = rotated_iou_bev(boxes[order[i]], boxes[rest[live]])
                idx = np.where(live)[0][ious > thresh]
                suppressed[i + 1 + idx] = True
    keep = np.asarray(keep, np.int64)
    if post_max_size is not None:
        keep = keep[:post_max_size]
    return keep


class CenterPointBBoxCoder:
    """Decode CenterPoint head outputs into boxes
    (centerpoint_bbox_coders.py:9 semantics, numpy)."""

    def __init__(self, pc_range: Sequence[float], out_size_factor: int,
                 voxel_size: Sequence[float], post_center_range=None,
                 max_num: int = 100, score_threshold: Optional[float] = None):
        self.pc_range = np.asarray(pc_range)
        self.out_size_factor = out_size_factor
        self.voxel_size = np.asarray(voxel_size)
        self.post_center_range = (np.asarray(post_center_range)
                                  if post_center_range is not None else None)
        self.max_num = max_num
        self.score_threshold = score_threshold

    def decode(self, heat: np.ndarray, rot_sine: np.ndarray,
               rot_cosine: np.ndarray, hei: np.ndarray, dim: np.ndarray,
               vel: Optional[np.ndarray], reg: np.ndarray
               ) -> List[Dict[str, np.ndarray]]:
        """heat: (B, n_cls, H, W); reg: (B, 2, H, W); hei: (B, 1, H, W);
        dim: (B, 3, H, W); rot_*: (B, 1, H, W); vel: (B, 2, H, W) or None."""
        b, n_cls, h, w = heat.shape
        out = []
        for bi in range(b):
            scores_all = heat[bi].reshape(n_cls, -1)
            flat = scores_all.reshape(-1)
            k = min(self.max_num, flat.size)
            top = np.argsort(-flat)[:k]
            cls_ids = top // (h * w)
            pix = top % (h * w)
            ys, xs = pix // w, pix % w
            scores = flat[top]

            rx = reg[bi, 0].reshape(-1)[pix]
            ry = reg[bi, 1].reshape(-1)[pix]
            cx = (xs + rx) * self.out_size_factor * self.voxel_size[0] \
                + self.pc_range[0]
            cy = (ys + ry) * self.out_size_factor * self.voxel_size[1] \
                + self.pc_range[1]
            cz = hei[bi, 0].reshape(-1)[pix]
            dims = np.exp(dim[bi].reshape(3, -1)[:, pix]).T
            rot = np.arctan2(rot_sine[bi, 0].reshape(-1)[pix],
                             rot_cosine[bi, 0].reshape(-1)[pix])
            cols = [cx, cy, cz, dims[:, 0], dims[:, 1], dims[:, 2], rot]
            if vel is not None:
                cols += [vel[bi, 0].reshape(-1)[pix],
                         vel[bi, 1].reshape(-1)[pix]]
            boxes = np.stack(cols, axis=1)

            mask = np.ones(k, bool)
            if self.score_threshold is not None:
                mask &= scores > self.score_threshold
            if self.post_center_range is not None:
                mask &= (boxes[:, :3] >= self.post_center_range[:3]).all(1)
                mask &= (boxes[:, :3] <= self.post_center_range[3:]).all(1)
            out.append({"bboxes": boxes[mask], "scores": scores[mask],
                        "labels": cls_ids[mask]})
        return out
