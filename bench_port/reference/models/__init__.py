from typing import Optional, Union

import torch

from bench_port.reference.config import ModelConfig
from bench_port.reference.models.dhd import DHDNet
from bench_port.reference.models.dhd_stereo import DHDStereoNet


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                device: Optional[Union[str, torch.device]] = None) -> DHDNet:
    """DHDNet for single-frame presets, DHDStereoNet for temporal ones, with
    uninitialised parameters (load the benchmark's weights)."""
    cls = DHDStereoNet if cfg.temporal else DHDNet
    return cls(cfg, dtype=dtype, device=device)


__all__ = ["DHDNet", "DHDStereoNet", "build_model"]
