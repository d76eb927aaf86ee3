"""CUDA graphs of the served frame.

A served frame launches about a thousand kernels (DHD-S at 200x200, most
of them small), which the host dispatches one by one more slowly than the
card runs them.  Here each *unit* of a served frame is captured once into
a ``torch.cuda.CUDAGraph`` and replayed in later frames.  A unit is a
top-level child module of the model (the ranges a trace of the frame opens
around them) or the stereo cost volume; the glue between units (permutes,
concatenations, casts, the frame's geometry, the history warp) stays
eager.  Every unit's kernels are the ones the eager frame launches: only
their dispatch changes.

When (:func:`engages`): an eval-mode call that records no autograd, on
CUDA, outside ``torch.compile`` and ``torch.export``, whose batch carries
the rig's cached plans that the model's kernels read (``pool_plan``, and
``cv_static`` for a stereo model), and for the streaming step a filled
cache.  Every other call (a stream's bootstrap frame, frames planned in
the call, the F-frame forward, training) runs eagerly, as it would
without this module.

The first engaged call of a signature runs eagerly: it warms up what the
units set up lazily (cuDNN's plans, the device constants and frustums).
The second captures every unit in frame order into one private memory
pool, replaying each as it is captured; later calls replay.  The
signature is the frame's input and cache shapes and dtypes, the compute
dtype, and the storage of the rig's plans; each unit also checks, before
each replay, that its module still holds the weights it was captured
with, where they were (a ``load_state_dict`` starts over).

Inputs: a tensor a unit is given is copied into the unit's own buffer,
unless it already is what the graph reads: an output of an earlier unit,
or a tensor of the rig's plans, both read where they lie.  Outputs: a
unit's outputs lie in the pool.  No tensor of this module owns them: the
frame's code does, as in an eager frame, so that once it lets go of one,
a later unit's capture may take its memory (the replays, in capture
order, write it after every read).  So the pool holds about an eager
frame's working set, and what outlives the frame (returned outputs, the
stream cache) is copied out by :meth:`FrameGraphs.own`.

A module unit is still called through ``__call__``, its ``forward``
replaced by the replay for the call, so its hooks fire around the replay
(and not inside the capture); a hook that returns new inputs is not seen
by the graph, and one that keeps a unit's output past the frame must
copy it.  The program's spans open in Python around the replays as
before.  The kernel wrappers' launch marks and counters are made while a
unit is captured, not when it is replayed; ``profiling.counters()`` counts
``graph_captures``, ``graph_replays`` and ``graph_eager_calls`` (a unit's
call in an engaged frame that ran eagerly).
"""
from __future__ import annotations

import contextlib
import dataclasses
import operator
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import torch

from dhd_tpu_torch import profiling

CALLS = ("frame", "stream", "frames")


def compiling() -> bool:
    """Whether ``torch.compile`` or ``torch.export`` is tracing."""
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def engages(call: str, *, training: bool, grad_enabled: bool,
            device: torch.device, compiling: bool, batch: Mapping,
            rig: Sequence[str], cache: Optional[Mapping] = None) -> bool:
    """Whether a call of a DHD model serves its frame from CUDA graphs.

    Args:
      call: ``"frame"`` (``DHDNet.forward``), ``"stream"`` (the streaming
        step) or ``"frames"`` (the F-frame forward, never graphed).
      training, grad_enabled: the model's mode and the grad mode inside
        its forward.
      device: the model's device.
      compiling: ``torch.compile`` or ``torch.export`` is tracing.
      batch: the call's batch.
      rig: the batch keys of the rig's cached plans that the model's
        served path reads; empty where it plans each frame itself (its
        plain pooling or cost volume).
      cache: the streaming step's cache (``{}`` for a bootstrap frame).
    """
    if call not in CALLS:
        raise ValueError(f"unknown call {call!r}; want one of {CALLS}")
    if call == "frames" or training or grad_enabled or compiling:
        return False
    if device.type != "cuda" or not rig \
            or any(batch.get(k) is None for k in rig):
        return False
    return call == "frame" or bool(cache) and cache.get("bev") is not None


def _leaves(x: Any, out: List) -> List:
    """``x``'s leaves in order: tensors and other values, through tuples,
    lists, dicts (their keys too) and dataclasses."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, dict):
        for k, v in x.items():
            out.append(k)
            _leaves(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        out.append(type(x))
        for f in dataclasses.fields(x):
            _leaves(getattr(x, f.name), out)
    else:
        out.append(x)
    return out


def _map(x: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``x`` with each tensor ``t`` replaced by ``fn(t)``, in
    :func:`_leaves` order, in new containers."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_map(v, fn) for v in x)
    if isinstance(x, dict):
        return {k: _map(v, fn) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _map(getattr(x, f.name), fn)
            for f in dataclasses.fields(x)})
    return x


def _view(t: torch.Tensor) -> torch.Tensor:
    """A tensor over ``t``'s memory that does not own it (the views of
    ``torch``'s own graph trees): while the graphs live, the pool keeps
    the memory, and once no tensor owns it, it may give it to a later
    unit's capture."""
    st = t.untyped_storage()
    memory = torch._C._construct_storage_from_data_pointer(
        st.data_ptr(), t.device, st.nbytes())
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        memory, t.storage_offset(), t.shape, t.stride())


def _tensors(x: Any) -> List[torch.Tensor]:
    return [t for t in _leaves(x, []) if isinstance(t, torch.Tensor)]


def _same(a: Any, b: Any) -> bool:
    return a is b or (type(a) is type(b) and a == b)


def signature(batch: Mapping, rig: Sequence[str],
              cache: Optional[Mapping], *extra) -> Tuple:
    """What the graphs of a frame hold fixed: the shapes and dtypes of the
    batch's and the cache's arrays, and the storage of the rig's plans."""
    key: List = list(extra)
    for name, values in (("batch", batch), ("cache", cache or {})):
        for k in sorted(values):
            v = values[k]
            if name == "batch" and k in rig:
                key.append((k, tuple(
                    (t.data_ptr(), tuple(t.shape), t.dtype)
                    if isinstance(t, torch.Tensor) else t
                    for t in _leaves(v, []))))
            elif hasattr(v, "shape") and hasattr(v, "dtype"):
                key.append((name, k, tuple(v.shape), str(v.dtype)))
    return tuple(key)


def _weights(fn: Callable) -> Tuple[List, List, List, List]:
    """Where a module unit's weights are held and what they were: the
    dicts that hold each parameter and buffer, the names, the tensors and
    their addresses (none for a function unit)."""
    holders, names, tensors = [], [], []
    if isinstance(fn, torch.nn.Module):
        for m in fn.modules():
            for held in (m._parameters, m._buffers):
                for name, t in held.items():
                    if t is not None:
                        holders.append(held)
                        names.append(name)
                        tensors.append(t)
    return holders, names, tensors, [t.data_ptr() for t in tensors]


def _record(run: Callable[[], Any], graphs: "FrameGraphs"
            ) -> Tuple[torch.cuda.CUDAGraph, Any]:
    """``run()`` captured into a graph on ``graphs``' capture stream, its
    memory from their private pool: the graph and what ``run`` returned
    (its values written by each replay)."""
    if graphs._stream is None:
        graphs._stream = torch.cuda.Stream(graphs._device)
        graphs._pool = torch.cuda.graph_pool_handle()
    stream, pool = graphs._stream, graphs._pool
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = run()
        except BaseException:
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
    return graph, out


class _Unit:
    """One captured unit: its graph, the tensors it reads (its inputs'
    buffers, the rig's tensors, and views of earlier units' outputs), its
    other arguments, views of its outputs and its module's weights."""
    __slots__ = ("name", "graph", "inputs", "buffer", "out", "weights")

    def __init__(self, name: str, graph, inputs: List, buffer: List[bool],
                 out: Any, weights: Tuple):
        self.name, self.graph, self.out = name, graph, out
        self.inputs, self.buffer, self.weights = inputs, buffer, weights

    def load(self, args: Tuple, kwargs: dict) -> bool:
        """Copy the call's inputs into the unit's buffers; False where the
        call or the weights are not what the graph was captured with."""
        leaves = _leaves((args, kwargs), [])
        if len(leaves) != len(self.inputs):
            return False
        copies = []
        for x, s, own in zip(leaves, self.inputs, self.buffer):
            if not isinstance(s, torch.Tensor):
                if not _same(x, s):
                    return False
            elif x is not s:
                if not isinstance(x, torch.Tensor) or x.shape != s.shape \
                        or x.dtype != s.dtype or x.device != s.device:
                    return False
                if x.data_ptr() != s.data_ptr() or x.stride() != s.stride():
                    if not own:
                        return False
                    copies.append((s, x))
        holders, names, tensors, ptrs = self.weights
        if not (all(map(operator.is_, map(dict.get, holders, names), tensors))
                and list(map(torch.Tensor.data_ptr, tensors)) == ptrs):
            return False
        for s, x in copies:
            s.copy_(x)
        return True

    def run(self, fn: Callable, args: Tuple, kwargs: dict,
            out: Any = None) -> Any:
        """The graph's replay, through a module's ``__call__`` and its
        hooks: its outputs, in new containers (a caller may change a dict
        it was given), the views of them or, in the frame that captured
        it, ``out``, the capture's own."""
        def replay(*_, **__):
            self.graph.replay()
            return _map(self.out if out is None else out, lambda t: t)
        if not isinstance(fn, torch.nn.Module):
            return replay()
        fn.__dict__["forward"] = replay
        try:
            return fn(*args, **kwargs)
        finally:
            del fn.__dict__["forward"]


class FrameGraphs:
    """The CUDA graphs of one model's served frame (the module docstring
    says how).  The model opens :meth:`frame` around a call and runs each
    unit through :meth:`call`."""

    def __init__(self):
        self._units: List[_Unit] = []
        self._owned: set = set()    # storages of the units' outputs
        self._rig: set = set()      # addresses of the rig's plans' tensors
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None
        self._device: Optional[torch.device] = None
        self._key = self._warm = None
        self._generation = 0
        self._mode: Optional[str] = None
        self._next = 0

    def __deepcopy__(self, memo):
        return FrameGraphs()        # a copied model captures its own

    def invalidate(self) -> None:
        """Capture anew at the next engaged frame (the weights changed)."""
        self._generation += 1

    @contextlib.contextmanager
    def frame(self, engaged: bool, batch: Mapping, rig: Sequence[str],
              cache: Optional[Mapping], device: torch.device, *extra):
        """A call of the model: eager unless ``engaged``; then warm-up,
        capture or replay by its signature (:func:`signature` of ``batch``,
        the ``rig`` keys, ``cache`` and ``extra``)."""
        if not engaged:
            yield
            return
        key = (signature(batch, rig, cache, *extra), self._generation)
        if key == self._key:
            mode = "replay"
        else:
            self._drop()
            mode = "capture" if key == self._warm else "warm"
            self._warm = key
        self._rig = {t.data_ptr() for k in rig for t in _tensors(batch[k])}
        self._device, self._mode, self._next = device, mode, 0
        try:
            yield
        except BaseException:
            if mode == "capture":
                self._drop()
            raise
        else:
            if self._mode == "capture":
                self._key, self._warm = key, None
        finally:
            self._mode = None

    def _drop(self) -> None:
        """Forget every graph, once no replay may still use its memory."""
        if self._units and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._units, self._owned = [], set()
        self._stream = self._pool = self._key = None

    def call(self, name: str, fn: Callable, *args, **kwargs) -> Any:
        """``fn(*args, **kwargs)``, the frame's unit ``name``: eager, or
        captured, or replayed."""
        mode = self._mode
        if mode is None:
            return fn(*args, **kwargs)
        if mode == "replay":
            unit = (self._units[self._next]
                    if self._next < len(self._units) else None)
            if unit is not None and unit.name == name \
                    and unit.load(args, kwargs):
                self._next += 1
                profiling.count("graph_replays")
                return unit.run(fn, args, kwargs)
            # not what was captured: the rest of the frame runs eagerly,
            # and the next engaged frame warms up anew
            self._mode = "eager"
            self._generation += 1
        elif mode == "capture":
            unit, out = self._capture(name, fn, args, kwargs)
            self._units.append(unit)
            self._next += 1
            profiling.count("graph_captures")
            return unit.run(fn, args, kwargs, out)
        profiling.count("graph_eager_calls")
        return fn(*args, **kwargs)

    def _capture(self, name: str, fn: Callable, args: Tuple,
                 kwargs: dict) -> Tuple[_Unit, Any]:
        """The unit captured, and what its capture returned.  The memory of
        its outputs, and of the earlier units' outputs it reads, is owned
        by the frame's code alone, as in an eager frame: what that code
        lets go of, a later unit's capture may take, and the replays, in
        capture order, run each unit after every read of what it
        overwrites."""
        inputs, buffer, captured = [], [], []
        for x in _leaves((args, kwargs), []):
            if not isinstance(x, torch.Tensor):
                inputs.append(x)
                buffer.append(False)
                continue
            if x.data_ptr() in self._rig:               # read in place
                inputs.append(x)
                buffer.append(False)
            elif x.untyped_storage().data_ptr() in self._owned:
                inputs.append(_view(x))     # an earlier unit's output
                buffer.append(False)
            else:
                x = x.clone()
                inputs.append(x)
                buffer.append(True)
            captured.append(x)
        it = iter(captured)
        sargs, skwargs = _map((args, kwargs), lambda t: next(it))
        forward = fn.forward if isinstance(fn, torch.nn.Module) else fn
        graph, out = _record(lambda: forward(*sargs, **skwargs), self)
        self._owned.update(t.untyped_storage().data_ptr()
                           for t in _tensors(out))
        return _Unit(name, graph, inputs, buffer, _map(out, _view),
                     _weights(fn)), out

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, or a copy of it where it lies in a graph's outputs, which
        later replays overwrite: for what outlives the frame."""
        if self._owned and t.untyped_storage().data_ptr() in self._owned:
            return t.clone()
        return t
