"""Kernel B3 (``ops/cost_volume_cuda.py``, the stereo matching cost) against
its roofline, in percent: the least time of a frame's cost over B3's
device time per frame.

Bytes: both frames' stride-4 stereo features in the served dtype, the fp32
warp plan (two coordinates a sample) and the fp32 cost, once each.
Operations, on the CUDA cores in fp32: 11 a channel for a sample on the
image (four bilinear taps, the difference, its magnitude, the sum), 3 for
one off it.  Which samples fall on the image is worked out from the
stream's geometry (two frames 0.5 m apart) by the plain reference's plan.
"""
import torch

from bench_port import bounds
from bench_port.reference.geometry import create_frustum, rigid_relative
from bench_port.reference.models.dhd_stereo import stream_geometry
from bench_port.reference.ops import build_cv_plan

KERNELS = ("cost_volume_kernel",)
FLOPS_ON, FLOPS_OFF = 11, 3


def read(ctx):
    t = ctx.trace.kernel_s(lambda k: k in KERNELS)
    if t <= 0:
        return None
    cfg, vt = ctx.cfg, ctx.cfg.vt
    f0, f1 = ctx.loop.frame(0), ctx.loop.frame(1)
    _, c2g0 = stream_geometry(f0["sensor2ego"].float(),
                              f0["ego2global"].float())
    _, c2g1 = stream_geometry(f1["sensor2ego"].float(),
                              f1["ego2global"].float())
    hs, ws = vt.input_size[0] // 4, vt.input_size[1] // 4
    frustum = create_frustum(vt.depth, vt.input_size, 4, vt.sid,
                             device=c2g0.device)
    uf, _ = build_cv_plan(frustum, rigid_relative(c2g0, c2g1),
                          f1["intrins"].float(), f1["post_rots"].float(),
                          f1["post_trans"].float(), hs, ws)
    n_off = int((uf < -1e3).sum())
    n_on = uf.numel() - n_off
    c = cfg.swin_embed_dims if cfg.backbone == "swin_base" else 256
    elem = torch.tensor([], dtype=ctx.loop.dtype).element_size()
    bn = cfg.num_cams
    nbytes = elem * 2 * bn * hs * ws * c + 4 * 3 * uf.numel()
    flops = c * (FLOPS_ON * n_on + FLOPS_OFF * n_off)
    least = bounds.least_s(nbytes, flops, bounds.FP32_FLOP_PER_S)
    return bounds.share(least * ctx.items, t)
