"""Device idle ms a frame inside the program's ``encode`` spans (the image
backbone and neck): the device-only stretch's gaps of 2 us or more whose
midpoint lies inside an ``encode`` span (``bench_port/spans.py``).  The
backbone's dispatch while the device waits."""
from bench_port import spans


def read(ctx):
    return spans.idle_ms(ctx, ("encode",))
