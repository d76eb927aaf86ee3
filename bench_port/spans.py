"""The port's own spans (``dhd_tpu_torch.profiling``) laid over a traced
stretch: the arithmetic of the span metrics.

The program records, while a profiler runs, each span of its served frame
(``forward`` and its stages) on the host clock (``time.time_ns``).  A
traced run's two stretches are its last profiled frames: of the last
``ctx.items + ctx.detail.items`` ``forward`` spans the device-only stretch
holds the first ``ctx.items``, the detail stretch the rest.  The host's
syncs are counted in the detail stretch, against the ranges the program
opens there, on the host's clock.

Kernel time inside a span is counted in the detail stretch, whose trace
holds the host's ranges, the program's spans among them.  A device range
of a ``record_function`` holds only the kernels launched directly inside
it, first to last, not those of ranges opened inside it; the device runs
one stream in launch order, so the kernels launched inside a span are
those from the first to the last kernel of the device ranges of every
range opened inside it, itself included (:func:`range_hulls`).  The
cost volume's plan is what its stage launches before B3.
(A kernel's start says little of when it was launched where the device
queues, and the trace's launch calls do not pair one to one with its
kernels: some calls enqueue nothing.)

Every reader returns None where there is nothing to read: a run off the
card, a program without spans of its own, or device ranges that do not
pair with the host's.

:func:`clock` and :func:`idle_ms` place the device-only stretch's idle
gaps among the spans by the marks the program makes just before each
launch of its own kernels.  A replayed CUDA graph makes no launch mark,
so no metric reads them: they stay for the card tests of eagerly served
frames in ``tests/test_torch_profiling.py``.
"""
from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from bench_port.trace import GAP_MIN_US

# the host's waits for the device, by their runtime call's name
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
B3 = "cost_volume_kernel"

Span = Tuple[str, int, float, float]        # name, depth, t0 and t1 in us


def records() -> Optional[List]:
    """The program's spans, or None for a program that records none."""
    try:
        from dhd_tpu_torch.profiling import spans
    except ImportError:
        return None
    return spans()


def _bounds(ctx, detail: bool = False
            ) -> Optional[Tuple[List, float, float]]:
    """The program's spans, and the first and last ns of the device-only
    stretch's ``forward`` spans (or, with ``detail``, the detail
    stretch's)."""
    if ctx.loop.device.type != "cuda":
        return None
    spans = records()
    if spans is None:
        return None
    # the traced run's two stretches are its last profiled frames
    n_detail = ctx.detail.items
    n = n_detail if detail else ctx.items
    forwards = [s for s in spans if s[0] == "forward"]
    forwards = forwards[len(forwards) - ctx.items - n_detail:]
    if detail:
        forwards = forwards[ctx.items:]
    if n <= 0 or len(forwards) < n:
        return None
    return spans, forwards[0][2], forwards[n - 1][3]


def launch_marks() -> List[Tuple[str, int]]:
    """The program's launch marks, ``(kernel, t_ns)``; none for a program
    that makes none."""
    try:
        from dhd_tpu_torch.profiling import launch_marks as marks
    except ImportError:
        return []
    return marks()


def stretch(ctx, detail: bool = False) -> Optional[List[Span]]:
    """The spans of the device-only stretch (or, with ``detail``, of the
    detail stretch), times in us on the program's clock."""
    b = _bounds(ctx, detail)
    if b is None:
        return None
    spans, lo, hi = b
    return [(name, depth, t0 / 1e3, t1 / 1e3)
            for name, depth, t0, t1 in spans if lo <= t0 and t1 <= hi]


class NoClock(Exception):
    """Why a stretch's device times cannot be put on the program's
    clock."""


def clock(kernels: Iterable, marks: Iterable, spans: Iterable[Span]
          ) -> Callable[[float], float]:
    """The program's time of a device trace's time.  The kernels of a
    name are the launches marked under that name, paired in order from
    the stretch's end, which holds every kernel launched in it (a trace
    can miss its first launches); in each ``forward`` span the marked
    launch that started soonest after its mark anchors the offset (the
    trace's time less the program's, plus that launch's latency), and
    between anchors the offset runs linearly: the trace's clock drifts
    against the program's by up to milliseconds over a stretch.  Raises
    :class:`NoClock`, saying why, where no frame has an anchor."""
    starts: Dict[str, List[float]] = defaultdict(list)
    for s, _, key in kernels:
        starts[key].append(s)
    marked: Dict[str, List[float]] = defaultdict(list)
    for key, t in marks:
        marked[key].append(t)
    if not marked:
        raise NoClock("the stretch holds no launch mark")
    pairs = sorted(pair for key, ts in marked.items()
                   for pair in zip(reversed(ts),
                                   reversed(starts.get(key, []))))
    if not pairs:
        counts = {k: len(v) for k, v in sorted(marked.items())}
        raise NoClock(
            f"the trace holds no kernel of a marked name: marks {counts}, "
            f"{sum(map(len, starts.values()))} kernels of "
            f"{len(starts)} names")
    anchors = []
    for name, _, t0, t1 in spans:
        if name == "forward":
            lags = [(s - t, s) for t, s in pairs if t0 <= t <= t1]
            if lags:
                anchors.append(min(lags)[::-1])
    if not anchors:
        raise NoClock(f"no forward span holds a marked launch of the "
                      f"{len(pairs)} the trace holds")
    anchors.sort()
    at = [a for a, _ in anchors]
    off = [o for _, o in anchors]

    def to_program(d: float) -> float:
        i = bisect.bisect_right(at, d)
        if i == 0 or i == len(at):
            return d - off[min(i, len(at) - 1)]
        w = (d - at[i - 1]) / (at[i] - at[i - 1])
        return d - (off[i - 1] + w * (off[i] - off[i - 1]))
    return to_program


def _merged(intervals: Iterable[Tuple[float, float]]
            ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _of(spans: Iterable[Span], names: Optional[Iterable[str]] = None
        ) -> List[Tuple[float, float]]:
    """The intervals of the spans of ``names`` (all where None)."""
    names = None if names is None else set(names)
    return [(t0, t1) for name, _, t0, t1 in spans
            if names is None or name in names]


class _Within:
    """Whether a time lies inside any of some intervals."""

    def __init__(self, intervals: Iterable[Tuple[float, float]]):
        merged = _merged(intervals)
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]

    def __call__(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def idle_ms(ctx, names: Optional[Iterable[str]] = None,
            outside: bool = False) -> Optional[float]:
    """Device idle ms a frame of the device-only stretch: its gaps of
    ``GAP_MIN_US`` or more whose midpoint, on the program's clock, lies
    inside a span of ``names`` (any span where None), or with
    ``outside`` inside no span at all."""
    b = _bounds(ctx)
    if b is None:
        return None
    spans = stretch(ctx)
    marks = [(k, t / 1e3) for k, t in launch_marks() if b[1] <= t <= b[2]]
    try:
        to_program = clock(ctx.trace.kernels, marks, spans)
    except NoClock as e:
        print(f"span readers: no clock for the device-only stretch: {e}",
              file=sys.stderr)
        return None
    inside = _Within(_of(spans, None if outside else names))
    busy = ctx.trace.busy_intervals()
    total = 0.0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 - e0 >= GAP_MIN_US \
                and inside(to_program(0.5 * (e0 + s1))) != outside:
            total += s1 - e0
    return total / 1e3 / ctx.items


def range_hulls(tr, names: Iterable[str]
                ) -> Optional[List[Tuple[float, float]]]:
    """The device intervals, merged, from the first to the last kernel
    launched inside each of the trace's host ranges named in ``names``:
    for each such range, the hull of the device ranges of every range
    opened inside it (itself included).  A name's device ranges pair in
    order with its host ranges that hold no other of that name (a
    device range's time is the device clock's, which may stand a
    millisecond off the host ranges'); None where a range inside one of
    ``names`` has device ranges that do not pair so."""
    names = set(names)
    host: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for s, e, name in tr.host:
        if name in tr.spans or name in names:
            host[name].append((s, e))
    placed, unpaired = [], []   # (host range, device range); host ranges
    for name, devs in tr.spans.items():
        occ = host.get(name, [])
        inner = [h for h in occ if not any(
            o is not h and h[0] <= o[0] and o[1] <= h[1] for o in occ)]
        if len(inner) == len(devs):
            placed += zip(inner, sorted(devs))
        else:
            unpaired += occ
    hulls = []
    for name in names:
        for h0, h1 in host.get(name, ()):
            if any(h0 <= a and b <= h1 for a, b in unpaired):
                return None
            inner = [d for (a, b), d in placed if h0 <= a and b <= h1]
            if inner:
                hulls.append((min(d[0] for d in inner),
                              max(d[1] for d in inner)))
    return _merged(hulls)


def _detail_ran(ctx, names: Iterable[str]) -> bool:
    """Whether the program recorded a span of ``names`` in the detail
    stretch."""
    st = stretch(ctx, detail=True)
    return st is not None and any(name in set(names) for name, *_ in st)


def kernel_ms(ctx, names: Iterable[str]) -> Optional[float]:
    """Device ms a frame of the detail stretch's kernels, copies and sets
    launched inside the program's spans of ``names`` (spans that open
    ranges); None where no such span ran."""
    if not _detail_ran(ctx, names):
        return None
    tr = ctx.detail
    hulls = range_hulls(tr, names)
    if hulls is None:
        return None
    inside = _Within(hulls)
    return sum(e - s for s, e, _ in tr.kernels if inside(s)) / 1e3 / tr.items


def plan_ms(ctx) -> Optional[float]:
    """Device ms a frame of the cost volume's warp plan in the detail
    stretch: in each ``cost_volume`` range's hull, the kernels before B3's
    (the plan is all the stage launches before B3); None where no
    ``cost_volume`` span ran or a hull holds no B3."""
    if not _detail_ran(ctx, ("cost_volume",)):
        return None
    tr = ctx.detail
    hulls = range_hulls(tr, ("cost_volume",))
    if not hulls:
        return None
    total = 0.0
    for a, b in hulls:
        inside = [k for k in tr.kernels if a <= k[0] < b]
        ends = [i for i, k in enumerate(inside) if k[2] == B3]
        if not ends:
            return None
        total += sum(e - s for s, e, _ in inside[:ends[0]])
    return total / 1e3 / tr.items


def syncs_per_frame(ctx) -> Optional[float]:
    """The host's waits for the device (:data:`SYNCS`) a frame inside the
    program's ``forward`` ranges of the detail stretch, whose trace holds
    both on the host's clock (the device-only stretch has no ranges, and
    its device clock drifts)."""
    if not _detail_ran(ctx, ("forward",)):
        return None
    tr = ctx.detail
    inside = _Within((s, e) for s, e, name in tr.host if name == "forward")
    return sum(1 for s, _, name in tr.host
               if name in SYNCS and inside(s)) / tr.items


def setup_s(ctx, name: str) -> Optional[float]:
    """Seconds in the set-up spans named ``name``."""
    if ctx.loop.device.type != "cuda":
        return None
    spans = records()
    if spans is None:
        return None
    times = [(t1 - t0) / 1e9 for n, _, t0, t1 in spans if n == name]
    return sum(times) if times else None
