"""Training checkpoints with ``torch.save``: counterpart of
``dhd_tpu/io/checkpoint.py`` (the mmcv checkpoint_config / EMA-save
equivalent, core/hook/ema.py:102-117, DHD-S.py:283).

A checkpoint holds the model's state_dict in the reference key space (what
``load_jax_variables`` fills, so a model-only load takes it too), the
optimiser's moments and schedule position, the EMA and its counter, the
step, and the dropout generator's state.  Loaded into the same objects it
gives the next step's numbers bit for bit.  The JAX package's orbax
checkpoints cannot be read without JAX and are not read.
"""
from __future__ import annotations

import os
from typing import BinaryIO, Optional, Union

import torch
import torch.nn as nn

PathLike = Union[str, os.PathLike]


def save_checkpoint(path: Union[PathLike, BinaryIO], model: nn.Module,
                    optimizer=None, ema=None, step: int = 0,
                    generator: Optional[torch.Generator] = None) -> None:
    """Write ``model`` (and the optional optimiser, EMA and generator) at
    ``step`` to ``path``, a file path or a binary file object.  To a path
    a temporary file is renamed into place, so a crash never leaves half a
    checkpoint under the name."""
    state = {"model": model.state_dict(), "step": int(step)}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    if ema is not None:
        state["ema"] = ema.state_dict()
    if generator is not None:
        state["generator"] = generator.get_state()
    if hasattr(path, "write"):
        torch.save(state, path)
        return
    tmp = f"{os.fspath(path)}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: Union[PathLike, BinaryIO], model: nn.Module,
                    optimizer=None, ema=None,
                    generator: Optional[torch.Generator] = None) -> int:
    """Load what :func:`save_checkpoint` wrote (to a path, or to a file
    object, read from its start) into the given objects (``strict=True``
    for the model) and return the step.  Tensors go to the device of the
    object they load into."""
    if hasattr(path, "seek"):
        path.seek(0)
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    if ema is not None:
        ema.load_state_dict(state["ema"])
    if generator is not None and "generator" in state:
        generator.set_state(state["generator"])
    return int(state["step"])
