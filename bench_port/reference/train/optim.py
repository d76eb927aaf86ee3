"""Optimiser and learning-rate schedule of the reference recipe:
counterpart of ``dhd_tpu/train/optim.py`` (DHD-S.py:261-270).

AdamW (lr 2e-4, weight decay 1e-2 on every parameter, betas 0.9 / 0.999,
eps 1e-8) after a clip of the gradients' global norm at 5, with mmcv's
"step" policy: a linear warmup over 200 iterations from ratio 0.001, then
a decay by ``step_gamma`` at each of ``step_epochs``.  As in optax, the
schedule is read at the step count before the step: step 0 runs at
lr * 0.001.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import torch

from bench_port.reference.config import OptimConfig


def make_lr_schedule(cfg: OptimConfig, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """The learning rate of step ``count``: warmup, then step decay."""
    def schedule(count: int) -> float:
        warm = cfg.warmup_ratio + (1.0 - cfg.warmup_ratio) * min(
            count / max(cfg.warmup_iters, 1), 1.0)
        epoch = count // max(steps_per_epoch, 1)
        decay = 1.0
        for e in cfg.step_epochs:
            if epoch >= e:
                decay *= cfg.step_gamma
        return cfg.lr * warm * decay
    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the summed squares of every element (optax's
    ``global_norm``), as a 0-dim fp32 tensor: no host read."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([t.float() for t in tensors])))


class AdamWSchedule:
    """``optax.chain(clip_by_global_norm(max), adamw(schedule, ...))``
    over ``params``, as the JAX package's ``make_optimizer`` builds it.

    :meth:`step` reads the parameters' ``.grad`` (a parameter that got
    none steps on a zero gradient, as optax's does), clips them, and takes
    one AdamW step at the schedule's rate for the current count.
    ``state_dict`` holds the moments and the count, the schedule's
    position.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: OptimConfig, steps_per_epoch: int = 1):
        self.params = [p for p in params if p.requires_grad]
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip and step; returns the global norm before clipping (a 0-dim
        tensor)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        # optax: select(norm < max, g, (g / norm) * max), with no host read
        keep = norm < self.cfg.grad_clip_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(
            keep, one, torch.full_like(norm, self.cfg.grad_clip_norm)))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])
