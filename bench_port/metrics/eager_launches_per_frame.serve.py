"""The kernel launches the host still dispatches one by one, a frame: the
detail stretch's ``cudaLaunchKernel``, ``cudaLaunchKernelExC`` and
``cuLaunchKernel`` runtime calls inside the program's ``forward`` ranges
(``bench_port/spans.py``).  A replayed CUDA graph is one
``cudaGraphLaunch``, whatever kernels it holds, and counts none."""
from bench_port import spans

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")


def read(ctx):
    if not spans._detail_ran(ctx, ("forward",)):
        return None
    tr = ctx.detail
    inside = spans._Within((s, e) for s, e, name in tr.host
                           if name == "forward")
    return sum(1 for s, _, name in tr.host
               if name in LAUNCHES and inside(s)) / tr.items
