"""Device idle ms a frame outside every span of the program: the
device-only stretch's gaps of 2 us or more whose midpoint lies inside no
span (``bench_port/spans.py``).  The caller's own work between forwards:
the argmax, its copy to the host, the loop.  With
``forward_idle_ms.serve`` it sums to the stretch's idle ms a frame."""
from bench_port import spans


def read(ctx):
    return spans.idle_ms(ctx, outside=True)
