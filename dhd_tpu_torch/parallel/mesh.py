"""Data parallelism: one process per GPU under ``torchrun``; counterpart of
``dhd_tpu/parallel/mesh.py``.

The reference trains with NCCL data parallelism
(tools/dist_train.sh:5-20).  The JAX package shards a global batch over a
device mesh, and under GSPMD its sharded step *is* the single-device step
over the global batch: every BatchNorm is a SyncBN, every loss divides by
batch-wide sums.  The port keeps those semantics with ``torch.distributed``
and no wrapper around the model:

* :func:`initialize_distributed` starts the process group from torchrun's
  ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` (NCCL on the GPU, gloo on the
  CPU);
* each process loads its contiguous rows of the global batch
  (:func:`process_batch_slice`, :func:`shard_batch`; the loader's
  ``shard``);
* the train-mode BatchNorm sums x and x^2 over every process and divides
  by the global batch's count (``nn/layers.py:_FlaxTrainBN``), and the
  losses sum their normalisers before they divide, both through an
  all-reduce that autograd differentiates (:func:`global_sums`);
* after the backward one all-reduce averages the gradients
  (:func:`all_reduce_gradients`).

Why the average is the global gradient: every process computes the same
global loss L from the summed normalisers, so the all-reduce's backward
(which sums the gradients arriving from every process) hands each process
N times dL/dS for its own partial sums.  A process's gradient is then N
times its own samples' share of dL/dθ, and the mean over the N processes
is the sum of the shares.  DDP is not used: its hooks fight the
recomputed (``torch.utils.checkpoint``) blocks and the history frames that
run without a gradient, and one all-reduce after the backward is exact.

Launch::

    torchrun --nproc_per_node=N -m dhd_tpu_torch.cli.train \\
        --preset dhd_s --synthetic --batch-size <global batch>
"""
from __future__ import annotations

import contextlib
import os
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    """Whether a process group is up (a group of one included)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def initialize_distributed(device: Optional[Union[str, torch.device]] = None,
                           always: bool = False) -> bool:
    """Join the job torchrun describes in the environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL on
    ``cuda`` (the process takes GPU ``LOCAL_RANK``), gloo on the CPU.

    A no-op that returns False when ``WORLD_SIZE`` is unset or 1, unless
    ``always`` asks for a group of one (which runs every collective of the
    distributed path on one device).  Returns True when a group is up."""
    if is_distributed():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and not always:
        return False
    device = torch.device(device if device is not None else "cuda")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, rank=int(os.environ.get("RANK", "0")),
                            world_size=world)
    return True


def shutdown() -> None:
    """Destroy the process group, if one is up."""
    if is_distributed():
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(device: torch.device) -> Iterator[torch.device]:
    """Inside, this process is in the job the environment describes
    (:func:`initialize_distributed`); yields its device (a bare ``cuda``
    made its own GPU).  A group started here is destroyed on the way out;
    one that was up already is left up."""
    started = not is_distributed()
    initialize_distributed(device)
    try:
        if device.type == "cuda" and device.index is None and \
                is_distributed():
            device = torch.device("cuda", torch.cuda.current_device())
        yield device
    finally:
        if started:
            shutdown()


def process_batch_slice(global_batch: int) -> slice:
    """The [start, stop) rows of a global batch this process loads: an
    equal contiguous share (the whole batch in one process)."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide "
                         f"over {n} processes")
    per = global_batch // n
    return slice(rank() * per, (rank() + 1) * per)


def shard_batch(batch: Dict[str, Any],
                device: Optional[Union[str, torch.device]] = None
                ) -> Dict[str, Any]:
    """This process's rows of a global batch of arrays (numpy or tensors),
    on ``device`` when one is given."""
    sl = process_batch_slice(len(next(iter(batch.values()))))
    return {k: (torch.as_tensor(np.asarray(v[sl]) if not torch.is_tensor(v)
                                else v[sl], device=device)
                if device is not None else v[sl])
            for k, v in batch.items()}


def global_sums(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``tensors`` each summed over every process, in one all-reduce that
    autograd differentiates (its backward sums the gradients arriving
    from every process); ``tensors`` themselves without a process group."""
    if not is_distributed():
        return tensors
    from torch.distributed.nn.functional import all_reduce
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]))
    return tuple(part.view_as(t) for t, part in
                 zip(tensors, flat.split([t.numel() for t in tensors])))


def global_rand(shape: Sequence[int], generator: Optional[torch.Generator],
                device: Union[str, torch.device]) -> torch.Tensor:
    """``torch.rand(shape)`` drawn per *global* sample: the draw of the
    whole global batch (``world_size() * shape[0]`` rows) from
    ``generator``, of which this process keeps its own rows.  With the same
    generator state on every process, a row's draw does not depend on how
    the batch is split."""
    n = world_size()
    if n == 1:
        return torch.rand(tuple(shape), generator=generator, device=device)
    full = torch.rand((n * shape[0],) + tuple(shape[1:]),
                      generator=generator, device=device)
    return full[rank() * shape[0]:(rank() + 1) * shape[0]]


def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Average the gradients over every process in one all-reduce of a
    flat buffer (module docstring: this is the global gradient)."""
    if not is_distributed():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world_size()
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def sum_over_processes(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every process, in place (no gradient)."""
    if is_distributed():
        dist.all_reduce(t)
    return t


def gather_objects(obj: Any) -> List[Any]:
    """Every process's ``obj`` in rank order (``[obj]`` in one process)."""
    if not is_distributed():
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if is_distributed():
        dist.barrier()
