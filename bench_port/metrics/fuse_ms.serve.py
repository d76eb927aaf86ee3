"""Kernel ms a frame of SFA and the occupancy head: the detail stretch's
kernels, copies and sets launched inside the program's ``fuse`` span
(``mix``, ``occ_head`` and the copy of the logits the caller keeps), the
modules' ranges opened inside it included (``bench_port/spans.py``).  One
of the three parts of the ``head`` span that ``bev_stage_ms.serve`` counts
whole."""
from bench_port import spans


def read(ctx):
    return spans.kernel_ms(ctx, ("fuse",))
