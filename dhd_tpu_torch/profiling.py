"""Profiling helpers built on ``torch.profiler``: counterpart of
``dhd_tpu/profiling.py``, with the same three functions and the same
return shape.

A traced run gives each named range's time per execution (the ranges are
``torch.profiler.record_function`` blocks of the traced code) and the time
per CUDA kernel name.  On a GPU these are device times from the CUDA
activity; a run on the CPU has no device, and then the numbers are the
host's, which the result says under ``clock``.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

_TEMPLATE = re.compile(r"<[^<>]*>")


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
    (``mghs_pool_cuda``) and its plan (``pool_plan_cuda``), B2, B3, B4 and
    B5.  A wrapper counts only where it launches its kernel."""
    from dhd_tpu_torch.ops import (fused_layer_norm_cuda, mghs_pool_cuda,
                                   sorted_segment_sum,
                                   stereo_cost_volume_cuda,
                                   window_attention_cuda)
    from dhd_tpu_torch.ops.mghs_pool_cuda import pool_plan_cuda

    return {fn.__name__: fn.launches
            for fn in (mghs_pool_cuda, pool_plan_cuda, sorted_segment_sum,
                       stereo_cost_volume_cuda, window_attention_cuda,
                       fused_layer_norm_cuda)}


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
