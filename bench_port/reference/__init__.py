"""The benchmark's plain reference: a frozen copy of the port's plain path.

Each module here is the port's module of the same name (``dhd_tpu_torch``
as it stood when the benchmark was defined) with every hand-written
kernel's dispatch removed, so that only the plain PyTorch arithmetic is
left: the Swin's window attention and LayerNorm, the MGHS pooling as one
``index_add_`` over unsorted points, the stereo cost volume planned
stepwise from the geometry in every call.  No pool plan or ``cv_static``
is kept.  The losses, the AdamW schedule and the EMA are copies too.
Docstrings that speak of kernels describe the port's module it was copied
from.

It imports nothing of ``dhd_tpu_torch`` or the JAX package and takes
nothing the port made: the benchmark hands it the inputs and the seeded
weights it hands the port.  It computes in fp32; run it under
:func:`fp32_exact`, which turns TF32 off.  ``nn.layers.
compute_operands_in_fp8`` (serving) and ``nn.layers.compute_in_fp8``
(training) turn it into the lower-precision control.
"""
import contextlib

import torch


@contextlib.contextmanager
def fp32_exact():
    """Inside, fp32 matmuls and convolutions on the card do not run in
    TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
