"""The UNet epilogue kernels (``ops/unet_epilogue.py``: eval BatchNorm and
ReLU, with the skip and the 2x2 max pool; the transposed conv's bias, pad
and concatenation) against their roofline, in percent: the least time of
a frame's epilogue launches over the device time of
``unet_bn_relu_kernel`` and ``unet_up_place_kernel`` per frame.

The frame's UNets are those the configuration builds: the three slab
encoders, and the BEV encoder where it is a UNet (DHD-M); each runs at the
BEV grid, B=1, with the ladder base..16 base.  On the card in eval with
autograd off a UNet launches 22 epilogues (:func:`unet_launch_bytes`): at
each of the four upper levels the encoder's two BatchNorms (the second
writing the skip into the level's concatenation buffer and its max pool
beside it), at the bottom two BatchNorms, and at each level on the way up
the transposed conv's placement and two BatchNorms.

Per launch, in the served dtype: its input read and its output written
once, the pooled output (a quarter of the level's map, rounded down) where
it pools, and BatchNorm's four fp32 vectors of C; for a placement, the
transposed conv's output and its bias read and the placed rows (the
skip's map, pad included) written.  No operation count: a few an element,
far under the bytes' time.  Where the trace's launches a frame are not
that count the reader reads nothing.
"""
import sys

import torch

from bench_port import bounds

KERNELS = ("unet_bn_relu_kernel", "unet_up_place_kernel")
BN_VECTORS = 4 * 4          # mean, var, weight, bias in fp32, bytes a channel


def bn_bytes(rows: int, c: int, elem: int, pooled: int = 0) -> int:
    """A BatchNorm and ReLU over ``rows`` rows of ``c``, which also writes
    ``pooled`` rows of its max pool."""
    return elem * (2 * rows + pooled) * c + BN_VECTORS * c


def place_bytes(up_rows: int, rows: int, c: int, elem: int) -> int:
    """A placement of the transposed conv's ``up_rows`` rows of ``c`` and
    its bias into ``rows`` rows of the concatenation."""
    return elem * (up_rows + 1 + rows) * c


def unet_launch_bytes(h: int, w: int, base: int, elem: int):
    """The bytes of each epilogue launch of one UNet on an (h, w) input."""
    sizes = []
    for _ in range(5):
        sizes.append((h, w))
        h, w = h // 2, w // 2
    out = []
    for level, (h, w) in enumerate(sizes):
        c, rows = base << level, h * w
        if level == 4:
            out += 2 * [bn_bytes(rows, c, elem)]
            continue
        # the encoder's, pooling the skip; the way up's placement and two
        hu, wu = sizes[level + 1]
        out += [bn_bytes(rows, c, elem),
                bn_bytes(rows, c, elem, (h // 2) * (w // 2)),
                place_bytes(4 * hu * wu, rows, c, elem)]
        out += 2 * [bn_bytes(rows, c, elem)]
    return out


def unets(cfg) -> int:
    """The UNets a frame runs."""
    return len(cfg.vt.slab_sizes) + (cfg.bev_encoder == "unet")


def _one(cfg, elem: int):
    return unet_launch_bytes(cfg.vt.y.size, cfg.vt.x.size, cfg.unet_base,
                             elem)


def frame_launches(cfg) -> int:
    return unets(cfg) * len(_one(cfg, 2))


def frame_least_s(cfg, elem: int) -> float:
    return bounds.least_s(unets(cfg) * sum(_one(cfg, elem)), 0.0,
                          bounds.FP32_FLOP_PER_S)


def read(ctx):
    t = ctx.trace.kernel_s(lambda k: k in KERNELS)
    if t <= 0:
        return None
    n = sum(1 for k in ctx.trace.kernels if k[2] in KERNELS)
    want = frame_launches(ctx.cfg) * ctx.items
    if n != want:
        print(f"unet_epilogue_roofline.serve: {n} epilogue launches in "
              f"{ctx.items} frames, where the count assumes {want}",
              file=sys.stderr)
        return None
    elem = torch.tensor([], dtype=ctx.loop.dtype).element_size()
    return bounds.share(frame_least_s(ctx.cfg, elem) * ctx.items, t)
