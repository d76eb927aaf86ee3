"""The share of the train step's kernel time spent in PyTorch's
elementwise and reduce kernels (autograd's pointwise passes, BatchNorm and
LayerNorm statistics, the optimizer's foreach passes), by kernel name, in
percent."""
import re

PATTERN = re.compile(r"elementwise_kernel|reduce_kernel|multi_tensor_apply")


def read(ctx):
    total = ctx.trace.kernel_s()
    if total <= 0 or ctx.loop.device.type != "cuda":
        return None
    return 100.0 * ctx.trace.kernel_s(lambda k: bool(PATTERN.search(k))) \
        / total
