"""Model FLOPs utilisation: the plain reference's FLOPs of one item
(counted by FlopCounterMode at the cell's shapes: the forward for serving,
forward and backward without recomputation for training) over the wall
time of an item of the untraced window times the card's dense bf16 peak,
in percent."""
from bench_port import bounds


def read(ctx):
    flops = ctx.model_flops()
    if not flops or ctx.item_s <= 0 or ctx.loop.device.type != "cuda":
        return None
    return 100.0 * flops / (ctx.item_s * bounds.BF16_FLOP_PER_S)
