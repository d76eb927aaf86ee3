"""Kernel B5 (``ops/layer_norm.py``, the Swin's LayerNorms) against its
roofline, in percent: the least time of every ``layer_norm_kernel`` launch
of a frame (Swin-B) over their device time per frame.

A served frame runs its Swin in eval on the card with autograd off, where
every block fuses its two LayerNorms with the attention's data movement
(``SwinBlock._fuses``): a block is a window launch and a residual launch,
both instantiations of the one kernel.  So a frame launches one plain
LayerNorm for the patch embedding, one for each patch merge and one for
each stage the neck reads, and two for each block
(:func:`frame_launches`; 6 plain and 24 + 24 fused in DHD-L, the counts
the port's card tests assert).  Per launch, in the served bf16, with its
fp32 weight and bias read once:

* a plain LayerNorm (the patch merge's over the merged map at 4C): x read
  and y written once;
* a block's window launch: x read (h w rows of C an image) and the window
  tensor written, whose rows are the map padded below and right to whole
  windows (hp wp rows an image), the padding's zero rows included;
* a block's residual launch: x and the attention output's h w rows read,
  the sum and its norm written.

8 fp32 operations an element normed, on the CUDA cores.  Where the trace's
launches a frame are not that count the frame fused otherwise than this
count assumes, and the reader reads nothing.
"""
import sys

from bench_port import bounds

KERNELS = ("layer_norm_kernel",)
FLOPS = 8
ACT, AFFINE = 2, 4          # bytes: a bf16 activation, an fp32 weight


def _padded(n: int, ws: int) -> int:
    return -(-n // ws) * ws


def frame_launches(cfg):
    """A served frame's launches: (kind, rows moved, rows normed, C), the
    rows moved being those read and written together; kind is "plain",
    "window" or "residual"."""
    imgs, ws = cfg.num_cams, cfg.swin_window
    h, w = cfg.vt.input_size[0] // 4, cfg.vt.input_size[1] // 4
    out = [("plain", 2 * imgs * h * w, imgs * h * w, cfg.swin_embed_dims)]
    for i, depth in enumerate(cfg.swin_depths):
        c = cfg.swin_embed_dims * 2 ** i
        rows = imgs * h * w
        wins = imgs * _padded(h, ws) * _padded(w, ws)
        out += depth * [("window", rows + wins, rows, c),
                        ("residual", 4 * rows, rows, c)]
        if i in cfg.swin_out_indices:
            out.append(("plain", 2 * rows, rows, c))
        h, w = (h + 1) // 2, (w + 1) // 2
        if i < len(cfg.swin_depths) - 1:
            merged = imgs * h * w
            out.append(("plain", 2 * merged, merged, 4 * c))
    return out


def launch_bytes(moved: int, c: int) -> int:
    return ACT * moved * c + 2 * AFFINE * c


def frame_least_s(cfg) -> float:
    return sum(bounds.least_s(launch_bytes(moved, c), FLOPS * rows * c,
                              bounds.FP32_FLOP_PER_S)
               for _, moved, rows, c in frame_launches(cfg))


def read(ctx):
    if ctx.cfg.backbone != "swin_base":
        return None
    t = ctx.trace.kernel_s(lambda k: k in KERNELS)
    if t <= 0:
        return None
    n = sum(1 for k in ctx.trace.kernels if k[2] in KERNELS)
    want = len(frame_launches(ctx.cfg)) * ctx.items
    if n != want:
        print(f"b5_roofline.serve: {n} LayerNorm launches in "
              f"{ctx.items} frames, where the count assumes {want}",
              file=sys.stderr)
        return None
    return bounds.share(frame_least_s(ctx.cfg) * ctx.items, t)
