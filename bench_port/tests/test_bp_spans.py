"""The span metrics' readers (``bench_port/spans.py``) by hand, on fake
trace, span and launch-mark records: two syncs inside ``forward`` and one
outside, the kernels launched inside a span from the device ranges opened
inside it, the cost volume's plan, set-up seconds, and nothing to read off
the card or from a program without spans; and the launch marks' clock,
which no metric reads: a gap inside ``encode``, a gap outside every span,
the trace's clock drifting, a stretch whose clock has no anchor."""
from __future__ import annotations

import importlib.util
import types

import pytest
import torch

import bp_helpers as H

from bench_port import spans
from bench_port.trace import Trace

METRICS = H.ROOT / "bench_port" / "metrics"
US = 1000                       # ns a microsecond
NEW = ("syncs_per_frame.serve", "bev_stage_ms.serve", "cv_plan_ms.serve",
       "init_weights_s", "kernel_load_s")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name.replace('.', '_')}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class FakeTrace:
    busy_intervals = Trace.busy_intervals

    def __init__(self, kernels, host, items, spans=None):
        self.kernels, self.host, self.items = kernels, host, items
        self.spans = spans or {}


def _span(name, depth, t0, t1):
    return (name, depth, t0 * US, t1 * US)


# the program's clock, in us: two frames traced on the device alone, then
# one in the detail stretch, and a set-up before them
SPANS = [
    ("setup.init_weights", 0, 10 ** 6, 35 * 10 ** 8),
    ("setup.kernel_load", 0, 4 * 10 ** 9, 4 * 10 ** 9 + 25 * 10 ** 7),
    _span("forward", 0, 1000, 1100), _span("encode", 1, 1005, 1040),
    _span("view_transform", 1, 1040, 1060), _span("head", 1, 1060, 1095),
    _span("forward", 0, 1200, 1300), _span("encode", 1, 1205, 1240),
    _span("head", 1, 1260, 1295),
    _span("forward", 0, 2000, 2100), _span("pre_process", 1, 2010, 2030),
    _span("cost_volume", 1, 2030, 2050), _span("head", 1, 2060, 2090)]
# B1's launches; the device trace runs 500 us ahead, its launch latency 3
MARKS = [("mghs_pool_kernel", 1050 * US), ("mghs_pool_kernel", 1250 * US),
         ("mghs_pool_kernel", 2043 * US)]
# device-only stretch: gaps of 10 (mid 1525 -> 1022, in encode), 8 (-> 1046,
# in view_transform), 1 (too short), 88 (-> 1103, outside every span) and
# 93 us (-> 1203.5, in forward alone)
KERNELS = [(1510.0, 1520.0, "a"), (1530.0, 1545.0, "b"),
           (1553.0, 1560.0, "mghs_pool_kernel"), (1561.0, 1562.0, "c"),
           (1650.0, 1660.0, "d"), (1753.0, 1760.0, "mghs_pool_kernel")]
HOST = [(1530.0, 1531.0, "cudaLaunchKernel"),
        (1650.0, 1651.0, "cudaStreamSynchronize")]
# detail stretch (trace clock): the host's ranges, the program's and the
# modules' inside them, and its syncs; the device queues, so its starts
# say nothing of the spans, and each device range holds only its direct
# kernels
DETAIL_HOST = [(3002.0, 3102.0, "forward"),
               (3012.0, 3031.0, "pre_process"),
               (3013.0, 3020.0, "pre_process_net"),
               (3014.0, 3016.0, "cudaLaunchKernel"),
               (3031.0, 3051.0, "cost_volume"),             # an outer one
               (3032.0, 3050.0, "cost_volume"),
               (3061.0, 3091.0, "head"),
               (3062.0, 3070.0, "img_bev_encoder_backbone"),
               (3080.0, 3090.0, "occ_head"),
               (3040.0, 3041.0, "cudaStreamSynchronize"),   # in forward
               (3095.0, 3096.0, "cudaMemcpy"),              # in forward
               (3110.0, 3111.0, "cudaStreamSynchronize")]   # the caller's
DETAIL_KERNELS = [(3516.0, 3521.0, "k"), (3522.0, 3523.0, "k"),
                  (3524.0, 3531.0, "k"), (3532.0, 3534.0, "Memset"),
                  (3535.0, 3545.0, "cost_volume_kernel"),
                  (3546.0, 3549.0, "softmax"), (3550.0, 3561.0, "k"),
                  (3562.0, 3565.0, "Memcpy DtoD"), (3566.0, 3570.0, "k"),
                  (3571.0, 3584.0, "argmax")]
DETAIL_RANGES = {"pre_process_net": [(3516.0, 3521.0)],
                 "pre_process": [(3522.0, 3523.0)],
                 "cost_volume": [(3524.0, 3549.0)],
                 "img_bev_encoder_backbone": [(3550.0, 3561.0)],
                 "head": [(3562.0, 3565.0)],
                 "occ_head": [(3566.0, 3570.0)]}


def _ctx(device="cuda", detail_kernels=DETAIL_KERNELS):
    return types.SimpleNamespace(
        trace=FakeTrace(KERNELS, HOST, 2), items=2,
        detail=FakeTrace(detail_kernels, DETAIL_HOST, 1, DETAIL_RANGES),
        loop=types.SimpleNamespace(device=torch.device(device)))


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: SPANS)
    monkeypatch.setattr(spans, "launch_marks", lambda: MARKS)


def test_launch_marks_put_the_trace_on_the_programs_clock():
    us = [(k, t / US) for k, t in MARKS[:2]]
    frames = [s for s in SPANS if s[0] == "forward"][:2]
    frames = [(n, d, t0 / US, t1 / US) for n, d, t0, t1 in frames]
    to_program = spans.clock(KERNELS, us, frames)
    assert to_program(1553.0) == pytest.approx(1050.0)
    assert to_program(1000.0) == pytest.approx(497.0)
    # the trace's clock drifting 100 us between the frames' anchors
    drift = KERNELS[:5] + [(1853.0, 1860.0, "mghs_pool_kernel")]
    to_program = spans.clock(drift, us, frames)
    assert to_program(1853.0) == pytest.approx(1250.0)
    assert to_program(1703.0) == pytest.approx(1703.0 - 553.0)
    # a trace that missed the stretch's first marked launch: the marks
    # pair with the kernels from the end
    to_program = spans.clock(KERNELS[:2] + KERNELS[3:], us, frames)
    assert to_program(1753.0) == pytest.approx(1250.0)
    assert to_program(1553.0) == pytest.approx(1050.0)
    # no marked kernel in the trace, no mark, no mark in a frame: no
    # clock, and why
    with pytest.raises(spans.NoClock, match="no kernel of a marked name"):
        spans.clock(KERNELS[:2], us, frames)
    with pytest.raises(spans.NoClock, match="no launch mark"):
        spans.clock(KERNELS, [], frames)
    with pytest.raises(spans.NoClock, match="no forward span"):
        spans.clock(KERNELS, [(k, t + 500.0) for k, t in us], frames)


def test_span_readers_by_hand(recorded):
    ctx = _ctx()
    assert reader("syncs_per_frame.serve")(ctx) == 2.0
    # pre_process 5 + 1, head 11 + 3 + 4 us; the plan 7 + 2 before B3
    assert reader("bev_stage_ms.serve")(ctx) == pytest.approx(0.024)
    assert reader("cv_plan_ms.serve")(ctx) == pytest.approx(0.009)
    assert reader("init_weights_s")(ctx) == pytest.approx(3.499)
    assert reader("kernel_load_s")(ctx) == pytest.approx(0.25)


def test_idle_splits_whole_between_forward_and_caller(recorded):
    ctx = _ctx()
    assert spans.idle_ms(ctx, ("encode",)) == pytest.approx(0.010 / 2)
    assert spans.idle_ms(ctx, ("forward",)) == \
        pytest.approx((10 + 8 + 93) / 1e3 / 2)
    assert spans.idle_ms(ctx, outside=True) == pytest.approx(0.088 / 2)
    busy = ctx.trace.busy_intervals()
    idle = sum(s1 - e0 for (_, e0), (s1, _) in zip(busy, busy[1:])
               if s1 - e0 >= 2.0) / 1e3 / ctx.items
    assert spans.idle_ms(ctx, ("forward",)) \
        + spans.idle_ms(ctx, outside=True) == pytest.approx(idle)
    assert spans.idle_ms(_ctx("cpu"), ("forward",)) is None


def test_a_span_holds_the_device_ranges_opened_inside_it():
    tr = FakeTrace(DETAIL_KERNELS, DETAIL_HOST, 1, DETAIL_RANGES)
    # head's own device range holds its direct kernel alone
    assert tr.spans["head"] == [(3562.0, 3565.0)]
    assert spans.range_hulls(tr, ("head", "pre_process")) == [
        (3516.0, 3523.0), (3550.0, 3570.0)]
    # the two nested cost_volume ranges give one hull
    assert spans.range_hulls(tr, ("cost_volume",)) == [(3524.0, 3549.0)]
    # the device's clock standing 2 ms behind the host's changes nothing
    early = FakeTrace(DETAIL_KERNELS, DETAIL_HOST, 1, {
        n: [(a - 2000.0, b - 2000.0) for a, b in v]
        for n, v in DETAIL_RANGES.items()})
    assert spans.range_hulls(early, ("head",)) == [(1550.0, 1570.0)]
    # a module's device ranges that do not pair with its host ranges
    torn = FakeTrace(DETAIL_KERNELS, DETAIL_HOST, 1, dict(
        DETAIL_RANGES, occ_head=[(3566.0, 3568.0), (3568.0, 3570.0)]))
    assert spans.range_hulls(torn, ("head",)) is None
    assert spans.range_hulls(torn, ("pre_process",)) == [(3516.0, 3523.0)]


def test_a_cost_volume_without_b3_reads_no_plan(recorded):
    ctx = _ctx(detail_kernels=[k for k in DETAIL_KERNELS
                               if k[2] != "cost_volume_kernel"])
    assert reader("cv_plan_ms.serve")(ctx) is None
    assert reader("bev_stage_ms.serve")(ctx) == pytest.approx(0.024)


def test_a_stretch_without_an_anchor_says_why(recorded, capsys):
    ctx = _ctx()
    ctx.trace = FakeTrace([k for k in KERNELS if k[2] != "mghs_pool_kernel"],
                          HOST, 2)
    assert spans.idle_ms(ctx, ("forward",)) is None
    assert "no kernel of a marked name" in capsys.readouterr().err


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_off_the_card_or_without_spans(name, recorded,
                                                       monkeypatch):
    assert reader(name)(_ctx("cpu")) is None
    monkeypatch.setattr(spans, "records", lambda: None)
    assert reader(name)(_ctx()) is None


def test_a_frame_without_the_span_reads_nothing(monkeypatch):
    no_plan = [s for s in SPANS if s[0] != "cost_volume"]
    monkeypatch.setattr(spans, "records", lambda: no_plan)
    assert reader("cv_plan_ms.serve")(_ctx()) is None
    assert reader("bev_stage_ms.serve")(_ctx()) == pytest.approx(0.024)
