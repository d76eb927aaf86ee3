"""Seconds of set-up in the program's ``setup.kernel_load`` spans: the
first load of each CUDA source's library, with its nvcc build where the
checkout has none yet."""
from bench_port import spans


def read(ctx):
    return spans.setup_s(ctx, "setup.kernel_load")
