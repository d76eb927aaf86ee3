"""Profiling of the port: its own spans, launch marks and counters, and
helpers built on ``torch.profiler``; counterpart of
``dhd_tpu/profiling.py``, with the same three trace functions and the same
return shape.

The program records three things here:

* spans (:func:`span`): named, nested intervals of its served frame
  (``forward``, ``encode``, ``cost_volume`` ...), recorded only while a
  ``torch.profiler`` runs, and its one-shot set-up (``setup.*``), recorded
  always.  A span under a profiler also opens a ``record_function`` of its
  name, so that a trace of the host's side shows it;
* launch marks (:func:`mark`): the host time just before each launch of
  the port's CUDA kernels, under the kernel's name, while a profiler runs.
  A device trace holds every kernel's name and start, so the k-th kernel
  of a name against the k-th mark of that name puts the spans on the
  device's timeline;
* counters (:func:`count`), always on: each kernel wrapper's launches
  (:func:`kernel_launches`), ``kernel_builds`` (nvcc runs) and
  ``kernel_loads``.

Times are ``time.time_ns()``, the host clock of the profiler's own events.
The records are the process's, as a profiler's are: a span's depth counts
the spans open around it, so spans nest as they should from one thread,
the one that serves.  They are bounded; what comes past the bound is
counted under ``records_dropped``.  Off (no profiler), a span costs one
check of a bool.

A traced run gives each named range's time per execution (the ranges are
``torch.profiler.record_function`` blocks of the traced code) and the time
per CUDA kernel name.  On a GPU these are device times from the CUDA
activity; a run on the CPU has no device, and then the numbers are the
host's, which the result says under ``clock``.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

_TEMPLATE = re.compile(r"<[^<>]*>")
MAX_RECORDS = 1 << 16           # spans, and launch marks, kept at most
# the kernel wrappers, whose launches the counters hold under these names
KERNEL_WRAPPERS = ("mghs_pool_cuda", "pool_plan_cuda", "sorted_segment_sum",
                   "stereo_cost_volume_cuda", "window_attention_cuda",
                   "fused_layer_norm_cuda", "unet_epilogue_cuda",
                   "swin_window_norm_cuda", "swin_residual_norm_cuda")

_spans: List[Tuple[str, int, int, int]] = []
_marks: List[Tuple[str, int]] = []
_counters: Dict[str, int] = defaultdict(int)
_depth = 0


class _Span:
    """One open span: its slot in the record, filled when it closes."""
    __slots__ = ("name", "slot", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _depth
        self.slot = len(_spans)
        if self.slot < MAX_RECORDS:
            _spans.append((self.name, _depth, 0, 0))
        else:
            self.slot = -1
            _counters["records_dropped"] += 1
        _depth += 1
        # the span holds its range: times outside record_function's calls
        self.t0 = time.time_ns()
        self.rf = None
        if (_autograd_profiler._is_profiler_enabled
                and not torch.compiler.is_compiling()):
            self.rf = record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        global _depth
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.time_ns()
        _depth -= 1
        if self.slot >= 0:
            _spans[self.slot] = (self.name, _depth, self.t0, t1)
        return False


class _Off:
    """The span of a frame with no profiler running: a context manager
    that does nothing.  Its enter and exit are a C function (``str.format``
    of the empty string, which returns a false ``""`` whatever it is
    given), so entering and leaving it runs no Python frame."""
    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


def span(name: str, always: bool = False):
    """A context manager that records ``(name, depth, t0_ns, t1_ns)`` and
    opens ``record_function(name)`` while a profiler runs, and does nothing
    otherwise; with ``always`` (one-shot set-up) it records without a
    profiler too."""
    if always or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def mark(kernel: str) -> None:
    """Record ``(kernel, t_ns)`` while a profiler runs: called just before
    the launch of the kernel of that name (its name in a device trace)."""
    if _autograd_profiler._is_profiler_enabled:
        if len(_marks) < MAX_RECORDS:
            _marks.append((kernel, time.time_ns()))
        else:
            _counters["records_dropped"] += 1


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counters[name] += n


def spans() -> List[Tuple[str, int, int, int]]:
    """The spans recorded, ``(name, depth, t0_ns, t1_ns)`` in the order
    they opened; depth 0 is outermost."""
    return list(_spans)


def launch_marks() -> List[Tuple[str, int]]:
    """The launch marks recorded, ``(kernel name, t_ns)`` in time order."""
    return list(_marks)


def counters() -> Dict[str, int]:
    """Every counter, by name."""
    return dict(_counters)


def reset() -> None:
    """Forget every span, mark and counter."""
    _spans.clear()
    _marks.clear()
    _counters.clear()


def _kernel_key(name: str, collapse: bool) -> str:
    """A kernel's name without its parameter list; with ``collapse`` also
    without template arguments, so instantiations of one kernel sum
    together."""
    key = name.replace("(anonymous namespace)::", "")
    if collapse:
        while _TEMPLATE.search(key):
            key = _TEMPLATE.sub("", key)
    key = key.split("(")[0].strip()
    return key.removeprefix("void ") or name[:40]


def kernel_launches() -> Dict[str, int]:
    """The launch counters of the CUDA kernels' wrappers, by name: B1
    (``mghs_pool_cuda``) and its plan (``pool_plan_cuda``), B2, B3, B4, B5,
    the UNet epilogues (``unet_epilogue_cuda``, both of
    ``ops/unet_epilogue.py``'s) and B5's two Swin block launches
    (``swin_window_norm_cuda``, ``swin_residual_norm_cuda``).  A wrapper
    counts only where it launches its kernel."""
    return {name: _counters.get(name, 0) for name in KERNEL_WRAPPERS}


def trace_device(run: Callable[[], None], device: torch.device,
                 collapse: bool = True) -> Dict:
    """Run ``run()`` under ``torch.profiler`` and sum its activity on
    ``device`` (a CUDA device, or the CPU).

    Returns a dict:
      modules: {range name: [ms, ...]} one entry per execution of each
        ``record_function`` range, in time order (device span of the range
        on a GPU).
      ops: {kernel name: total ms}; op_events: {kernel name: count}.
      op_hlo: {kernel name: full signature}, only with ``collapse=False``
        (then template arguments stay in the names, so instantiations stay
        apart).
      clock: 'device' for CUDA device times, 'host' for a CPU-only run.
      ranges: {range name: reading} over all its executions: host_ms (the
        host's time in the range), syncs and sync_host_ms (the host's
        synchronize calls inside it and their time) and, on a GPU,
        device_span_ms (first to last device event of the range) and
        kernel_ms (the kernels and copies inside that span).
      syncs: {"syncs": n, "sync_host_ms": t}, every synchronize call the
        host made in the run.
    """
    on_gpu = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_gpu else [])
    with profile(activities=activities) as prof:
        run()
        if on_gpu:
            torch.cuda.synchronize()
    events = prof.events()
    kind = DeviceType.CUDA if on_gpu else DeviceType.CPU
    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    # a range shows on the device as its span, under the range's name
    ranges = {e.name for e in events if e.device_type == DeviceType.CPU
              and getattr(e, "is_user_annotation", False)}
    if on_gpu:
        ranges |= cpu_names & {e.name for e in events
                               if e.device_type == kind}

    modules: Dict[str, list] = defaultdict(list)
    ops: Dict[str, float] = defaultdict(float)
    op_events: Dict[str, int] = defaultdict(int)
    op_hlo: Dict[str, str] = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.device_type != kind:
            continue
        if e.name in ranges:
            modules[e.name].append(e.time_range.elapsed_us() / 1e3)
        elif on_gpu and e.name not in cpu_names:       # a kernel or a copy
            key = _kernel_key(e.name, collapse)
            ops[key] += e.time_range.elapsed_us() / 1e3
            op_events[key] += 1
            if not collapse:
                op_hlo.setdefault(key, e.name)
    syncs = [e for e in events if e.device_type == DeviceType.CPU
             and "Synchronize" in e.name]
    readings: Dict[str, Dict] = {}
    for name in ranges:
        cpu = [e for e in events
               if e.name == name and e.device_type == DeviceType.CPU]
        if not cpu:
            continue
        lo, hi = cpu[0].time_range.start, cpu[-1].time_range.end
        inside = [e for e in syncs
                  if lo <= e.time_range.start and e.time_range.end <= hi]
        reading = {"host_ms": sum(e.cpu_time_total for e in cpu) / 1e3,
                   "syncs": len(inside),
                   "sync_host_ms": sum(e.cpu_time_total
                                       for e in inside) / 1e3}
        dev = [e for e in events if e.name == name and e.device_type == kind]
        if on_gpu and dev:
            g0 = min(e.time_range.start for e in dev)
            g1 = max(e.time_range.end for e in dev)
            reading["device_span_ms"] = (g1 - g0) / 1e3
            reading["kernel_ms"] = sum(
                e.time_range.elapsed_us() for e in events
                if e.device_type == kind and e.name not in cpu_names
                and g0 <= e.time_range.start < g1) / 1e3
        readings[name] = reading
    if not on_gpu:
        # no device: the host's self time of each operator
        for e in prof.key_averages():
            if e.key not in ranges:
                ops[e.key] += e.self_cpu_time_total / 1e3
                op_events[e.key] += e.count
    return {"modules": dict(modules), "ops": dict(ops),
            "op_events": dict(op_events), "op_hlo": op_hlo,
            "clock": "device" if on_gpu else "host", "ranges": readings,
            "syncs": {"syncs": len(syncs), "sync_host_ms": sum(
                e.cpu_time_total for e in syncs) / 1e3}}


def module_ms(prof: Dict, name_substr: str, drop_first: int = 0
              ) -> Optional[float]:
    """Mean ms per execution of the range whose name contains
    ``name_substr`` (e.g. 'step'), optionally dropping warm-up runs."""
    for name, durs in prof["modules"].items():
        if name_substr in name:
            durs = durs[drop_first:] if len(durs) > drop_first else durs
            if durs:
                return sum(durs) / len(durs)
    return None


def top_ops(prof: Dict, n: int = 25):
    """[(kernel name, total ms, count)] sorted by total time."""
    rows = [(k, v, prof["op_events"].get(k, 0))
            for k, v in prof["ops"].items()]
    rows.sort(key=lambda r: -r[1])
    return rows[:n]
