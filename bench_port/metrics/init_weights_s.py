"""Seconds of set-up in the program's ``setup.init_weights`` span: the
model's constructor drawing every weight on the host before the served
weights replace them."""
from bench_port import spans


def read(ctx):
    return spans.setup_s(ctx, "setup.init_weights")
