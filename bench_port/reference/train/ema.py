"""MEGVII-style EMA of the weights (core/hook/ema.py:17-117): counterpart
of ``dhd_tpu/train/ema.py``.

decay(t) = base_decay * (1 - exp(-t / 2000)), the update counter starting
at ``init_updates`` (10560 for DHD), over every float parameter and the
BatchNorms' running mean and variance (the JAX package's ``batch_stats``;
torch's ``num_batches_tracked`` has no counterpart there and is left out).
The EMA holds copies, never views of the live tensors.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn as nn


def _tracked(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The live tensors the EMA follows, by state_dict key."""
    out = {k: p for k, p in model.named_parameters()
           if p.is_floating_point()}
    out.update((k, b) for k, b in model.named_buffers()
               if k.endswith(("running_mean", "running_var")))
    return out


class ModelEMA:
    """The EMA of ``model``'s weights and BatchNorm statistics."""

    def __init__(self, model: nn.Module, init_updates: int,
                 base_decay: float = 0.999):
        self.updates = int(init_updates)
        self.base_decay = base_decay
        self.shadow = {k: t.detach().clone()
                       for k, t in _tracked(model).items()}

    def decay(self) -> float:
        """The decay of the next update, in fp32 as JAX computes it."""
        t = np.float32(self.updates + 1)
        return float(np.float32(self.base_decay)
                     * (np.float32(1.0) - np.exp(-t / np.float32(2000.0))))

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        """shadow = shadow * d + (1 - d) * live, then count the update."""
        d = self.decay()
        live = _tracked(model)
        shadow = list(self.shadow.values())
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, [live[k].to(v.dtype)
                                     for k, v in self.shadow.items()],
                            alpha=float(np.float32(1.0) - np.float32(d)))
        self.updates += 1

    @contextlib.contextmanager
    def applied(self, model: nn.Module):
        """Inside, ``model`` holds the EMA's weights and statistics; its
        own come back after."""
        live = _tracked(model)
        kept = {k: t.detach().clone() for k, t in live.items()}
        with torch.no_grad():
            for k, t in live.items():
                t.copy_(self.shadow[k])
        try:
            yield model
        finally:
            with torch.no_grad():
                for k, t in live.items():
                    t.copy_(kept[k])

    def state_dict(self) -> Dict:
        return {"updates": self.updates, "shadow": dict(self.shadow)}

    def load_state_dict(self, state: Dict) -> None:
        self.updates = int(state["updates"])
        for k, v in state["shadow"].items():
            self.shadow[k].copy_(v)
