"""The traced stretch of a window and its reduction to what the per-layer
metrics read.

The ranges are opened by the benchmark's own files, where a loop asks for
them: a ``record_function`` around each child module of the model
(entered and left by forward pre- and post-hooks) and around
``_cost_volume``.  The reduction is the
port's ``profiling.trace_device`` arithmetic (as it stood when the
benchmark was defined), frozen: a range shows on the device as its span,
and a stage's time is the time of the kernels inside that span, not the
span itself, which on a host-paced frame holds the host's gaps.
"""
from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict
from typing import Callable, Iterable, List, Optional, Tuple

import torch

_TEMPLATE = re.compile(r"<[^<>]*>")
GAP_MIN_US = 2.0    # shorter device gaps are not idle gaps worth naming


def kernel_key(name: str) -> str:
    """A kernel's name without its parameter list and template arguments,
    so that instantiations of one kernel sum together."""
    key = name.replace("(anonymous namespace)::", "")
    while _TEMPLATE.search(key):
        key = _TEMPLATE.sub("", key)
    key = key.split("(")[0].strip()
    return key.removeprefix("void ") or name[:40]


@contextlib.contextmanager
def module_ranges(model: torch.nn.Module, methods: Iterable[str] = ()):
    """Inside, each child module of ``model`` runs in a range of its name,
    and each bound method named in ``methods`` in a range of its name
    without the leading underscore."""
    handles, saved = [], []
    for name, child in model.named_children():
        stack: List = []

        def enter(mod, args, name=name, stack=stack):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            stack.append(rf)

        def leave(mod, args, out, stack=stack):
            stack.pop().__exit__(None, None, None)
        handles.append(child.register_forward_pre_hook(enter))
        handles.append(child.register_forward_hook(leave))
    for meth in methods:
        fn = getattr(model, meth)

        def wrapped(*a, _fn=fn, _name=meth.lstrip("_"), **kw):
            with torch.profiler.record_function(_name):
                return _fn(*a, **kw)
        setattr(model, meth, wrapped)
        saved.append(meth)
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        for meth in saved:
            delattr(model, meth)


class Trace:
    """The device side of a traced stretch of ``items`` frames or steps.

    kernels: (start_us, end_us, key) of every kernel, copy and set on the
    device, in start order.  spans: {range name: [(start_us, end_us)]}, the
    device spans of each range's executions.  window_s: the stretch's wall
    time by the host's clock.
    """

    def __init__(self, prof, items: int, window_s: float):
        self.items = items
        self.window_s = window_s
        events = prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        cpu_names = set()
        self.host: List[Tuple[float, float, str]] = []
        for e in events:
            if e.device_type != cuda:
                cpu_names.add(e.name)
                self.host.append((e.time_range.start, e.time_range.end,
                                  e.name))
        self.host.sort()
        self._host_starts = [h[0] for h in self.host]
        kernels, spans = [], defaultdict(list)
        for e in events:
            if e.device_type != cuda:
                continue
            t = (e.time_range.start, e.time_range.end)
            if e.name in cpu_names:         # a range's span on the device
                spans[e.name].append(t)
            else:
                kernels.append(t + (kernel_key(e.name),))
        kernels.sort()
        self.kernels = kernels
        self.spans = dict(spans)
        self._starts = [k[0] for k in kernels]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the kernels' intervals, in order."""
        out: List[List[float]] = []
        for s, e, _ in self.kernels:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_s(self, match: Optional[Callable[[str], bool]] = None
                 ) -> float:
        """Seconds of the kernels whose key ``match`` accepts (all)."""
        return sum(e - s for s, e, k in self.kernels
                   if match is None or match(k)) / 1e6

    def launches(self) -> int:
        return len(self.kernels)

    def range_kernel_s(self, name: str) -> Optional[float]:
        """Seconds of the kernels that start inside the device spans of
        range ``name``, over all its executions; None if it never ran on
        the device."""
        spans = self.spans.get(name)
        if not spans:
            return None
        total = 0.0
        for g0, g1 in spans:
            i = bisect.bisect_left(self._starts, g0)
            while i < len(self.kernels) and self.kernels[i][0] < g1:
                total += self.kernels[i][1] - self.kernels[i][0]
                i += 1
        return total / 1e6

    def top_kernels(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for s, e, k in self.kernels:
            by[k] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def _host_at(self, t: float) -> str:
        """The innermost host event running at ``t`` (the latest started
        that has not ended), or "host idle"."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(i - 400, -1), -1):
            s, e, name = self.host[j]
            if e >= t:
                return name
        return "host idle"

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle gaps between busy intervals, summed by what
        the host was doing in their middle, longest first."""
        by = defaultdict(float)
        busy = self.busy_intervals()
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            if s1 - e0 >= GAP_MIN_US:
                by[self._host_at(0.5 * (e0 + s1))] += (s1 - e0) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def traced(run: Callable[[], None], items: int, host: bool = False
           ) -> Trace:
    """``run()`` (``items`` frames or steps, ending in a synchronize) under
    ``torch.profiler`` on the card: the device's activity alone, or with
    ``host`` the host's operators and ranges too, which slows the host's
    dispatch several times over (so that stretch's idle share is not the
    program's)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return Trace(prof, items, window_s)
