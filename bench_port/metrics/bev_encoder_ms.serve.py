"""Kernel ms a frame of the BEV encoder: the detail stretch's kernels,
copies and sets launched inside the program's ``bev_encoder`` span
(``img_bev_encoder_backbone``, and ``img_bev_encoder_neck`` where the
model has one), the modules' ranges opened inside it included
(``bench_port/spans.py``).  One of the three parts of the ``head`` span
that ``bev_stage_ms.serve`` counts whole."""
from bench_port import spans


def read(ctx):
    return spans.kernel_ms(ctx, ("bev_encoder",))
