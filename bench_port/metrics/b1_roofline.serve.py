"""Kernel B1 (``ops/mghs_pool_cuda.py``, the fused MGHS pooling with the
rig's cached plan) against its roofline, in percent: the least time of a
frame's pooling over B1's device time per frame.

The least time is the larger of its bytes over the HBM peak and its
operations over the fp32 CUDA-core peak.  Bytes: the depth and feature
inputs, the band gates and both outputs (vox, bev) once in the served
dtype, 8 bytes per point inside the grid (its depth-table index and z)
and the pillars' starts.  Operations: a multiply and the bev add per
channel of every point inside the grid (the gated vox adds are left out,
so the bound errs low).  The points inside the grid are counted from the
rig by the plain reference's geometry.
"""
import torch

from bench_port import bounds
from bench_port.reference.geometry import create_frustum, frustum_to_ego
from bench_port.reference.models.dhd import GEOM_KEYS
from bench_port.reference.ops import compute_pool_indices

KERNELS = ("mghs_pool_kernel", "mghs_pool_combine_kernel")


def points_in_grid(ctx) -> int:
    vt = ctx.cfg.vt
    geom = ctx.loop.pool_geometry()
    frustum = create_frustum(vt.depth, vt.input_size, vt.downsample, vt.sid,
                             device=geom["bda"].device)
    idx = compute_pool_indices(
        frustum_to_ego(frustum, *(geom[k] for k in GEOM_KEYS)), vt)
    return int((idx.key != idx.num_seg_vox).sum())


def read(ctx):
    t = ctx.trace.kernel_s(lambda k: k in KERNELS)
    if t <= 0:
        return None
    cfg, vt = ctx.cfg, ctx.cfg.vt
    b, n = 1, cfg.num_cams
    fh, fw = vt.feat_size
    c = vt.out_channels
    pillars = b * vt.y.size * vt.x.size
    elem = torch.tensor([], dtype=ctx.loop.dtype).element_size()
    n_valid = points_in_grid(ctx)
    nbytes = (elem * (pillars * vt.z_fine.size * c + pillars * c
                      + b * n * fh * fw * (vt.D + c + 3))
              + 8 * n_valid + 4 * (pillars + 1))
    least = bounds.least_s(nbytes, 2 * n_valid * c, bounds.FP32_FLOP_PER_S)
    return bounds.share(least * ctx.items, t)
