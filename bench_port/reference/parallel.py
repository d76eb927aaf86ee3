"""One-process stand-ins for the data-parallel helpers the copied modules
call: the reference runs in one process, so a sum over processes is the
tensor itself and a random draw is ``torch.rand``."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch


def world_size() -> int:
    return 1


def global_sums(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    return tensors


def global_rand(shape: Sequence[int], generator: Optional[torch.Generator],
                device: Union[str, torch.device]) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, device=device)
