"""Frustum -> voxel pooling of the MGHS view transformer in plain PyTorch:
the port's ``ops/voxel_pool.py`` segment ids and its unsorted
``index_add_`` pooling (what the port's CPU path runs), frozen.  There is
no plan: every call works the indices out from the geometry."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from bench_port.reference.config import ViewTransformConfig


def _trunc_index(coord: torch.Tensor, lower: float, interval: float
                 ) -> torch.Tensor:
    """Voxelize with round-toward-zero semantics.

    The reference uses torch ``.long()`` (truncation), so values in
    (lower - interval, lower) also map to index 0 and pass the >= 0 bound
    check (lss_heightmap.py:331-348); replicated for parity.
    """
    return ((coord - lower) / interval).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class PoolIndices:
    """Pooling indices for one batch of frustum geometry, flattened over
    (B, N, D, fH, fW) points.  ``seg_*`` equal ``num_seg_*`` (one past the
    end) for dropped points."""
    seg_bev: torch.Tensor     # (P,) int32 into [0, B*Dy*Dx]
    seg_vox: torch.Tensor     # (P,) int32 into [0, B*Dy*Dx*Dz]
    key: torch.Tensor         # (P,) int32 sort key: z-clipped voxel id for
    #                           every BEV-valid point, num_seg_vox otherwise
    band: torch.Tensor        # (P,) int32 in [0, 2], band of the point's z
    num_seg_bev: int
    num_seg_vox: int


def compute_pool_indices(coords: torch.Tensor, vt: ViewTransformConfig
                         ) -> PoolIndices:
    """Segment ids for the fused MGHS pooling.

    Args:
      coords: (B, N, D, fH, fW, 3) ego-frame xyz from
        :func:`dhd_tpu_torch.geometry.frustum_to_ego`.
    """
    b = coords.shape[0]
    dx, dy = vt.x.size, vt.y.size
    dz_fine = vt.z_fine.size
    s1, s2, _ = vt.slab_sizes

    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    xi = _trunc_index(x, vt.x.lower, vt.x.interval)
    yi = _trunc_index(y, vt.y.lower, vt.y.interval)
    zi_full = _trunc_index(z, vt.z_full.lower, vt.z_full.interval)
    zi_fine = _trunc_index(z, vt.z_fine.lower, vt.z_fine.interval)

    in_xy = (xi >= 0) & (xi < dx) & (yi >= 0) & (yi < dy)
    ok_bev = in_xy & (zi_full >= 0) & (zi_full < vt.z_full.size)
    ok_vox = in_xy & (zi_fine >= 0) & (zi_fine < dz_fine)

    batch_idx = torch.arange(b, dtype=torch.int32, device=coords.device
                             ).reshape((b,) + (1,) * (coords.dim() - 2))
    num_seg_bev = b * vt.z_full.size * dy * dx
    num_seg_vox = b * dy * dx * dz_fine
    pillar = (batch_idx * dy + yi) * dx + xi
    zi_c = zi_fine.clamp(0, dz_fine - 1)
    full = torch.full_like(pillar, num_seg_bev)
    seg_bev = torch.where(ok_bev, pillar * vt.z_full.size + zi_full, full)
    full = torch.full_like(pillar, num_seg_vox)
    seg_vox = torch.where(ok_vox, pillar * dz_fine + zi_fine, full)
    key = torch.where(ok_bev, pillar * dz_fine + zi_c, full)
    band = (zi_c >= s1).to(torch.int32) + (zi_c >= s1 + s2).to(torch.int32)
    return PoolIndices(seg_bev=seg_bev.reshape(-1),
                       seg_vox=seg_vox.reshape(-1),
                       key=key.reshape(-1), band=band.reshape(-1),
                       num_seg_bev=num_seg_bev, num_seg_vox=num_seg_vox)


def mghs_pool(depth: torch.Tensor, feat: torch.Tensor,
              band_mask: torch.Tensor, idx: PoolIndices,
              vt: ViewTransformConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused MGHS pooling as one ``index_add_`` over unsorted points (the
    plain path the CPU serves without a plan).

    Args:
      depth: (B, N, D, fH, fW) softmaxed depth distribution.
      feat: (B, N, fH, fW, C) context features.
      band_mask: (B, N, fH, fW, 3) per-pixel height-band gate in {0, 1}.
    Returns:
      bev (B, Dy, Dx, C) and vox (B, Dy, Dx, Dz, C) in feat.dtype, summed
      in fp32.
    """
    if vt.z_full.size != 1:
        raise ValueError("the main DHD grid is z-collapsed (Dz=1)")
    b, n, d, fh, fw = depth.shape
    c = feat.shape[-1]
    dx, dy, dz = vt.x.size, vt.y.size, vt.z_fine.size

    # depth x feat outer product (B, N, D, fH, fW, C), shared by both halves
    vals = (depth[..., None] * feat[:, :, None]).reshape(-1, c)
    bg = idx.band.reshape(b, n, d, fh, fw)
    bm = band_mask[:, :, None]                       # (B, N, 1, fH, fW, 3)
    gate = ((bg == 0) * bm[..., 0] + (bg == 1) * bm[..., 1]
            + (bg == 2) * bm[..., 2])
    # a point valid for BEV whose fine z is out of range adds to bev only
    gate_eff = gate.reshape(-1, 1) * (idx.seg_vox != idx.num_seg_vox
                                      ).reshape(-1, 1).to(vals.dtype)
    # both halves scatter by the z-clipped voxel key; bev is the z-sum of
    # the ungated half (ok_vox implies ok_bev)
    both = torch.cat([vals, vals * gate_eff], dim=-1).float()
    out = torch.zeros(idx.num_seg_vox + 1, 2 * c, dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, idx.key.long(), both)
    out = out[:-1].reshape(b, dy, dx, dz, 2 * c)
    bev = out[..., :c].sum(dim=3)
    vox = out[..., c:]
    return bev.to(feat.dtype), vox.to(feat.dtype)
