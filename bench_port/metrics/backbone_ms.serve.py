"""Milliseconds of device kernels per frame inside the range ``img_backbone``
(opened by the benchmark around that part of the model, in the traced
stretch that records the host's side): the kernels' own time, not the range's span, which on a host-paced frame holds the
host's gaps."""

RANGE = "img_backbone"


def read(ctx):
    s = ctx.detail.range_kernel_s(RANGE)
    if s is None:
        return None
    return 1e3 * s / ctx.detail.items
