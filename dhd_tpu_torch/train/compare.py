"""How two train steps' gradients are compared: the port's GPU step
against its CPU step (tests/test_torch_card_train.py) and the port's step
against the JAX package's (the CPU tests).

Two fp32 forwards differ by ~1e-6 of their activations' scale, enough to
flip a few ReLU gates, and one flipped gate moves a weight gradient by
~1/sqrt(pixels) of its peak; so the gradient is held in L2, as a whole and
per tensor (:func:`gradient_errors`).  The conv biases right ahead of a
BatchNorm have an exact gradient of 0 and hold rounding noise in any two
runs (:func:`zero_gradient_params`).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch
from torch import nn


def zero_gradient_params(model: nn.Module) -> List[str]:
    """The names of the conv biases right ahead of a BatchNorm: in training
    the BN subtracts the batch mean, so their exact gradient is 0 (their
    computed one is noise, scaled by 1 / sqrt(eps) where the BN sees a
    constant channel)."""
    from dhd_tpu_torch.nn.layers import BatchNorm2d

    names = []
    for name, mod in model.named_modules():
        kids = list(mod.named_children())
        for (a, conv), (_, bn) in zip(kids, kids[1:]):
            if isinstance(conv, nn.Conv2d) and conv.bias is not None \
                    and isinstance(bn, BatchNorm2d):
                names.append(f"{name}.{a}.bias" if name else f"{a}.bias")
    return names


def _f64(x) -> torch.Tensor:
    t = x.detach() if torch.is_tensor(x) else torch.from_numpy(np.array(x))
    return t.to("cpu", torch.float64).flatten()


def gradient_errors(got: Dict, want: Dict, skip: Iterable[str] = ()
                    ) -> Tuple[float, float, float]:
    """The rel-L2 distance of ``got`` from ``want`` (dicts name -> tensor
    or array; ``want`` may hold more) over all of ``got``'s tensors
    together, and the median and the largest per-tensor one, the ``skip``
    tensors aside."""
    skip = set(skip)
    keys = [k for k in got if k not in skip]
    a = {k: _f64(got[k]) for k in keys}
    b = {k: _f64(want[k]) for k in keys}
    whole = float(torch.cat([a[k] - b[k] for k in keys]).norm()
                  / torch.cat([b[k] for k in keys]).norm().clamp_min(1e-300))
    per = sorted(float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-300))
                 for k in keys)
    return whole, per[len(per) // 2], per[-1]
