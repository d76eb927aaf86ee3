"""Kernel ms a frame of the slab encoders: the detail stretch's kernels,
copies and sets launched inside the program's ``voxel_encoders`` span
(the three height slabs collapsed, their UNets and the concatenation),
the modules' ranges opened inside it included (``bench_port/spans.py``).
One of the three parts of the ``head`` span that ``bev_stage_ms.serve``
counts whole."""
from bench_port import spans


def read(ctx):
    return spans.kernel_ms(ctx, ("voxel_encoders",))
