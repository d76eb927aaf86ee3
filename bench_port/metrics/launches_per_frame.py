"""Kernels, copies and sets the device ran per item (frame or step) of
the traced stretch: the eager dispatch's launches."""


def read(ctx):
    if not ctx.trace.kernels:
        return None
    return ctx.trace.launches() / ctx.items
