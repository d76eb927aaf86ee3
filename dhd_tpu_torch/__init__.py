"""dhd_tpu_torch: DHD occupancy prediction in PyTorch for NVIDIA Hopper.

The PyTorch/CUDA port of ``dhd_tpu`` (which stays the reference).  The
layout mirrors ``dhd_tpu/``: ``config``, ``geometry``, ``data``, ``nn``,
``ops``, ``models``, ``io``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; hand-written CUDA kernels live in ``csrc/`` and are
built on first use.
"""
from dhd_tpu_torch.config import ModelConfig, get_config

__all__ = ["ModelConfig", "get_config"]
