from typing import Optional, Union

import torch

from dhd_tpu_torch.config import ModelConfig
from dhd_tpu_torch.models.dhd import (DHDNet, MGHSTransform,
                                      band_masks_from_height,
                                      build_batch_pool_plan, collapse_z,
                                      init_weights, stereo_feat_channels)
from dhd_tpu_torch.models.dhd_stereo import (DHDStereoNet,
                                             build_stream_cv_static,
                                             build_stream_pool_plan,
                                             prepare_stereo_inputs,
                                             shift_grid, stream_geometry,
                                             uncollapse_z)


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                device: Optional[Union[str, torch.device]] = None,
                generator: Optional[torch.Generator] = None) -> DHDNet:
    """DHDNet for single-frame presets, DHDStereoNet for temporal ones (the
    reference registry's 'DHD' vs 'DHD_stereo')."""
    cls = DHDStereoNet if cfg.temporal else DHDNet
    return cls(cfg, dtype=dtype, device=device, generator=generator)


__all__ = ["DHDNet", "DHDStereoNet", "MGHSTransform",
           "band_masks_from_height", "build_batch_pool_plan", "build_model",
           "build_stream_cv_static", "build_stream_pool_plan", "collapse_z",
           "init_weights", "prepare_stereo_inputs", "shift_grid",
           "stereo_feat_channels", "stream_geometry", "uncollapse_z"]
