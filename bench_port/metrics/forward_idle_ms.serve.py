"""Device idle ms a frame inside the program's ``forward`` spans: the
device-only stretch's gaps of 2 us or more whose midpoint, put on the
program's clock by the port's own kernel launches, lies inside a
``forward`` span (``bench_port/spans.py``).  The host dispatching the
model while the device waits."""
from bench_port import spans


def read(ctx):
    return spans.idle_ms(ctx, ("forward",))
