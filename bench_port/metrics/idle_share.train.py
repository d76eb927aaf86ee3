"""The device's idle share of the untraced window, in percent: one minus
the device's busy time an item (the union of its kernels' intervals over
the traced stretch, divided by the stretch's items) over the untraced
window's seconds an item.  The profiler slows the host, so the traced
stretch's own wall time would read the idle share high."""


def read(ctx):
    if not ctx.trace.kernels or ctx.items <= 0 or ctx.item_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.items / ctx.item_s)
