"""Frustum -> voxel pooling for the MGHS view transformer: counterpart of
``dhd_tpu/ops/voxel_pool.py``.

Every frustum point exists; points outside the grid carry the segment id
one past the end and are dropped.  The reference's four ``bev_pool_v2``
passes (full z-collapsed grid + 3 height-band slabs, lss_heightmap.py:
407-459) fuse into one BEV splat plus one height-gated fine-voxel splat:
a point lands in exactly one fine z voxel, which belongs to exactly one
height band, and the band masks gate features per pixel.

The fine-voxel layout is z-minor (seg = pillar * Dz + z), so the pooled
grid comes out (B, Dy, Dx, Dz, C) and sorting by voxel id also sorts by
BEV pillar — one sort feeds both outputs of the CUDA kernel
(:mod:`dhd_tpu_torch.ops.mghs_pool_cuda`).

:func:`bev_pool` and :func:`bev_pool_v2` keep the reference's legacy
pooling API; their sums are :func:`~dhd_tpu_torch.ops.segment_sum.
segment_sum_pooling` (kernel B2 on the GPU).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dhd_tpu_torch.config import ViewTransformConfig
from dhd_tpu_torch.ops.segment_sum import segment_sum_pooling


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


@dataclasses.dataclass(frozen=True)
class PoolPlan:
    """Geometry-only half of the pooling, reusable across the frames of a
    fixed camera rig (the reference's 'accelerate' serving mode,
    lss_heightmap.py:374-378).  Points are sorted by their z-minor voxel
    key; a pillar's points are ``[starts[p], starts[p + 1])``."""
    dix_s: torch.Tensor       # (P,) int32: index of the point's depth in the
    #                           pixel-major (B, N, fH, fW, D) depth table
    z_s: torch.Tensor         # (P,) int32: fine z voxel, -1 when outside the
    #                           fine grid (the point still reaches bev)
    starts: torch.Tensor      # (B*Dy*Dx + 1,) int32 pillar intervals
    grid: Tuple[int, int, int, int]          # (B, Dy, Dx, Dz)
    band_edges: Tuple[int, int]              # band(z) = (z >= e0) + (z >= e1)
    # the CUDA kernel's schedule (ops/mghs_pool_cuda.py:
    # pool_schedule_plain), geometry only; a plan on the card has it, a
    # CPU plan does not
    tasks: Optional[torch.Tensor] = None   # (T, 4) int32 (pillar, first
    #                                        point, end, slot)
    splits: Optional[torch.Tensor] = None  # (S, 4) int32 (pillar, first
    #                                        slot, pieces, 0)
    n_slots: int = 0          # fp32 partial blocks the kernel may write


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


def build_pool_plan(idx: PoolIndices, vt: ViewTransformConfig,
                    cams_shape: Tuple[int, int, int, int, int],
                    fit_scratch: bool = False) -> PoolPlan:
    """Sort the points by voxel key once and find each pillar's interval;
    on the card, also the kernel's schedule, all by one call of
    :func:`~dhd_tpu_torch.ops.mghs_pool_cuda.pool_plan_cuda`.

    Args:
      cams_shape: (B, N, D, fH, fW) of the depth tensor.
      fit_scratch: count the scratch slots the schedule uses (one read
        back to the host, for a plan built once and kept) instead of
        bounding them by the shapes.
    """
    b = cams_shape[0]
    dz = vt.z_fine.size
    key_s, order = torch.sort(idx.key, stable=True)
    s1, s2, _ = vt.slab_sizes
    plan = dict(grid=(b, vt.y.size, vt.x.size, dz), band_edges=(s1, s1 + s2))
    if not key_s.is_cuda:
        dix_s, z_s, starts = sorted_tables(key_s, order, idx.seg_vox,
                                           idx.num_seg_vox, cams_shape, dz)
        return PoolPlan(dix_s=dix_s, z_s=z_s, starts=starts, **plan)
    # the kernel module imports PoolPlan from here
    from dhd_tpu_torch.ops.mghs_pool_cuda import pool_plan_cuda
    dix_s, z_s, starts, tasks, splits, n_slots = pool_plan_cuda(
        key_s, order, idx.seg_vox, idx.num_seg_vox, cams_shape, dz)
    if fit_scratch:
        n_slots = int(splits[:, 2].sum())
    return PoolPlan(dix_s=dix_s, z_s=z_s, starts=starts, tasks=tasks,
                    splits=splits, n_slots=n_slots, **plan)


def sorted_tables(key_s: torch.Tensor, order: torch.Tensor,
                  seg_vox: torch.Tensor, num_seg_vox: int,
                  cams_shape: Tuple[int, int, int, int, int], dz: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A plan's ``dix_s``, ``z_s`` and ``starts`` from the points sorted by
    key (``key_s``, and ``order`` the sort's indices), in torch ops."""
    _, _, d, fh, fw = cams_shape
    hw = fh * fw
    # point id in (B, N, D, fH, fW) order -> pixel-major depth-table index
    cam = order // (d * hw)
    dix_s = (cam * hw + order % hw) * d + (order // hw) % d
    z_ok = seg_vox[order] != num_seg_vox
    z_s = torch.where(z_ok, key_s % dz, torch.full_like(key_s, -1))
    bounds = torch.arange(num_seg_vox // dz + 1, dtype=key_s.dtype,
                          device=key_s.device) * dz
    starts = torch.searchsorted(key_s, bounds, out_int32=True)
    return dix_s.to(torch.int32), z_s.to(torch.int32), starts


def bev_pool(feats: torch.Tensor, coords: torch.Tensor, b: int, dz: int,
             dy: int, dx: int, pool: str = "sum") -> torch.Tensor:
    """The reference's legacy bev_pool (v1) API (ops/bev_pool/bev_pool.py:
    6-126): counterpart of ``dhd_tpu/ops/voxel_pool.py:bev_pool``.

    Args:
      feats: (P, C) point features.
      coords: (P, 4) int (x, y, z, batch) voxel coordinates; points outside
        the grid are dropped.
      pool: 'sum' (kernel B2 on the GPU) or 'max' (empty voxels 0).
    Returns:
      (B, C, Dz, Dy, Dx) pooled grid in feats.dtype.
    """
    c = feats.shape[-1]
    x, y, z, bi = coords.long().unbind(-1)
    valid = ((x >= 0) & (x < dx) & (y >= 0) & (y < dy)
             & (z >= 0) & (z < dz) & (bi >= 0) & (bi < b))
    num_seg = b * dz * dy * dx
    seg = torch.where(valid, ((bi * dz + z) * dy + y) * dx + x, num_seg)
    if pool == "sum":
        out = segment_sum_pooling(feats, seg, num_seg)
    elif pool == "max":
        out = torch.full((num_seg + 1, c), float("-inf"), dtype=feats.dtype,
                         device=feats.device)
        out = out.scatter_reduce(0, seg[:, None].expand(-1, c), feats,
                                 "amax")[:-1]
        out = torch.where(torch.isneginf(out), 0.0, out)
    else:
        raise ValueError(pool)
    return out.reshape(b, dz, dy, dx, c).permute(0, 4, 1, 2, 3)


def bev_pool_v2(depth: torch.Tensor, feat: torch.Tensor,
                ranks_depth: torch.Tensor, ranks_feat: torch.Tensor,
                ranks_bev: torch.Tensor,
                bev_feat_shape: Tuple[int, int, int, int, int]
                ) -> torch.Tensor:
    """The reference's ``bev_pool_v2`` API (ops/bev_pool_v2/bev_pool.py:
    86-106): ``out[ranks_bev[i]] += depth.flat[ranks_depth[i]] *
    feat.rows[ranks_feat[i]]``; counterpart of
    ``dhd_tpu/ops/voxel_pool.py:bev_pool_v2``.  Ranks need not be sorted;
    the sum is :func:`segment_sum_pooling`, so depth and feat get
    gradients.

    Args:
      depth: (B, N, D, fH, fW); feat: (B, N, fH, fW, C).
      ranks_*: (P,) int index arrays.
      bev_feat_shape: (B, Dz, Dy, Dx, C).
    Returns:
      (B, Dz, Dy, Dx, C) pooled grid, channels-last.
    """
    b, dz, dy, dx, c = bev_feat_shape
    vals = (depth.reshape(-1)[ranks_depth.long(), None]
            * feat.reshape(-1, feat.shape[-1])[ranks_feat.long()])
    out = segment_sum_pooling(vals, ranks_bev, b * dz * dy * dx)
    return out.reshape(b, dz, dy, dx, c)
