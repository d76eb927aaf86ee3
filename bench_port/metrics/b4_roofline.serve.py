"""Kernel B4 (``ops/window_attention.py``, the Swin's window attention on
the tensor cores) against its roofline, in percent: the least time of a
frame's 24 window attentions (Swin-B) over B4's device time per frame.

Per call: qkv read and the output written once, the bias and, in a
shifted block, the mask read once, in bf16; 4 N^2 hd operations per
(window, head) at the dense bf16 peak.  The shapes follow from the
configuration: each stage's token map padded to whole windows, the blocks
alternately unshifted and shifted.
"""
from bench_port import bounds

KERNELS = ("window_attention_mma_kernel", "window_attention_kernel")


def frame_least_s(cfg) -> float:
    ws = cfg.swin_window
    n = ws * ws
    h, w = cfg.vt.input_size[0] // 4, cfg.vt.input_size[1] // 4
    total = 0.0
    for i, depth in enumerate(cfg.swin_depths):
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        c, heads = cfg.swin_embed_dims * 2 ** i, cfg.swin_num_heads[i]
        n_img = (hp // ws) * (wp // ws)
        wins = cfg.num_cams * n_img
        for d in range(depth):
            mask = n_img * n * n if d % 2 else 0
            nbytes = 2 * (wins * n * 3 * c + wins * n * c + heads * n * n
                          + mask)
            flops = wins * heads * 4 * n * n * (c // heads)
            total += bounds.least_s(nbytes, flops, bounds.BF16_FLOP_PER_S)
        h, w = (h + 1) // 2, (w + 1) // 2
    return total


def read(ctx):
    t = ctx.trace.kernel_s(lambda k: k in KERNELS)
    if t <= 0 or ctx.cfg.backbone != "swin_base":
        return None
    return bounds.share(frame_least_s(ctx.cfg) * ctx.items, t)
