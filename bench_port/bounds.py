"""The yardstick's table of peaks and the least time of a kernel's work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): the rates every roofline share and MFU is stated against.  A card
set below 700 W runs slower under load; the run prints its power limit
beside the shares.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # HBM3
BF16_FLOP_PER_S = 989e12        # bf16 / fp16 on the tensor cores
FP32_FLOP_PER_S = 67e12         # fp32 on the CUDA cores


def least_s(nbytes: float, flops: float, flop_per_s: float) -> float:
    """The least time of work that moves ``nbytes`` (each input byte read
    once, each output byte written once) and computes ``flops`` at
    ``flop_per_s``: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)


def share(least: float, measured: float) -> float:
    """A roofline share in percent: the least time over the measured."""
    return 100.0 * least / measured
