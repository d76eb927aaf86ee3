"""The device's busy time a frame over the traced stretch, in ms: the
union of its kernels' intervals over the stretch's frames.  A device
number, steady where the host paces the frame."""


def read(ctx):
    if not ctx.trace.kernels or ctx.items <= 0:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.items
