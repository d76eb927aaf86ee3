"""The host's waits for the device a frame inside the program's
``forward`` ranges: the detail stretch's ``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize`` and synchronous
``cudaMemcpy`` calls (``bench_port/spans.py``).  A CUDA graph of the frame
needs none."""
from bench_port import spans


def read(ctx):
    return spans.syncs_per_frame(ctx)
