"""Bilinear warping with zero padding: counterpart of
``dhd_tpu/ops/warp.py:grid_sample_2d``.

The JAX function is plain XLA (a block gather), not a Pallas kernel, so the
port calls ``F.grid_sample`` behind the JAX function's channels-last
signature.  ``F.grid_sample`` takes the grid in the input's dtype; a bf16
grid would place samples only to ~1/256 of the map's width (about half a
cell of the 200-wide BEV grid), so a bf16 input is sampled in fp32 and
cast back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """Sample ``img`` at normalised grid locations, zero outside.

    Args:
      img: (B, H, W, C).
      grid: (B, Ho, Wo, 2) with (x, y) in [-1, 1]; with ``align_corners``
        -1 maps to pixel 0 and +1 to pixel W-1 (H-1), torch's convention.
    Returns:
      (B, Ho, Wo, C) in img.dtype.
    """
    work = img.dtype if img.dtype in (torch.float32, torch.float64) \
        else torch.float32
    out = F.grid_sample(img.permute(0, 3, 1, 2).to(work), grid.to(work),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=align_corners)
    return out.permute(0, 2, 3, 1).to(img.dtype)
