"""Milliseconds of device kernels per frame inside the range ``cost_volume``
(opened by the benchmark around that part of the model, in the traced
stretch that records the host's side): the kernels' own time, not the range's span, which on a host-paced frame holds the
host's gaps."""

RANGE = "cost_volume"


def read(ctx):
    s = ctx.detail.range_kernel_s(RANGE)
    if s is None:
        return None
    return 1e3 * s / ctx.detail.items
