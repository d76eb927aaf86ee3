"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import torch


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values: Sequence, device: Union[str, torch.device],
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A small constant tensor, copied to ``device`` once per process and
    shared after that.  ``torch.tensor(..., device="cuda")`` copies from
    pageable host memory, which waits for the device: a served frame must
    not.  Callers must not modify the result in place."""
    values = tuple(tuple(v) if isinstance(v, (list, tuple)) else v
                   for v in values)
    return _constant(values, torch.device(device), dtype)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the GPU.  Raises when no GPU is present and none was
    asked for: the port never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
