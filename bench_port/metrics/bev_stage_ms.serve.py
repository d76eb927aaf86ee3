"""Kernel ms a frame of the BEV stage: the detail stretch's kernels,
copies and sets launched inside the program's ``pre_process``,
``history_warp`` and ``head`` spans, the modules' ranges opened inside
them included (``bench_port/spans.py``): the busy time that the backbone,
view-transform and cost-volume metrics leave unnamed."""
from bench_port import spans

SPANS = ("pre_process", "history_warp", "head")


def read(ctx):
    return spans.kernel_ms(ctx, SPANS)
