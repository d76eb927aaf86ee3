"""Kernel B5 (``ops/layer_norm.py``, the Swin's LayerNorms) against its
roofline, in percent: the least time of a frame's 54 LayerNorms (Swin-B)
over B5's device time per frame.

Per call: x read and y written once in bf16, the fp32 weight and bias
once; 8 fp32 operations an element on the CUDA cores.  The calls: the
patch embedding's norm, two per block, each patch merge's norm of 4C
channels over the merged map, and the out norms of the stages the neck
reads.
"""
from bench_port import bounds

KERNELS = ("layer_norm_kernel",)
FLOPS = 8


def _least(rows: int, c: int) -> float:
    return bounds.least_s(2 * 2 * rows * c + 2 * 4 * c, FLOPS * rows * c,
                          bounds.FP32_FLOP_PER_S)


def frame_least_s(cfg) -> float:
    h, w = cfg.vt.input_size[0] // 4, cfg.vt.input_size[1] // 4
    imgs = cfg.num_cams
    total = _least(imgs * h * w, cfg.swin_embed_dims)
    for i, depth in enumerate(cfg.swin_depths):
        c = cfg.swin_embed_dims * 2 ** i
        total += 2 * depth * _least(imgs * h * w, c)
        if i in cfg.swin_out_indices:
            total += _least(imgs * h * w, c)
        if i < len(cfg.swin_depths) - 1:
            h, w = (h + 1) // 2, (w + 1) // 2
            total += _least(imgs * h * w, 4 * c)
    return total


def read(ctx):
    t = ctx.trace.kernel_s(lambda k: k in KERNELS)
    if t <= 0 or ctx.cfg.backbone != "swin_base":
        return None
    return bounds.share(frame_least_s(ctx.cfg) * ctx.items, t)
