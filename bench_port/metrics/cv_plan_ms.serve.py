"""Kernel ms a frame of the cost volume's per-frame warp plan, the eager
passes before kernel B3: in the detail stretch, the kernels launched
inside each of the program's ``cost_volume`` spans before B3's
(``bench_port/spans.py``)."""
from bench_port import spans


def read(ctx):
    return spans.plan_ms(ctx)
