"""The cell ``dhd_m.stream`` on the CPU at a small DHD-M-shaped
configuration: a run end to end and traced with the result's keys, both
planted faults and the fp8 control reading false under the cell's own
limits; and the three readers that split the ``head`` span
(``bev_encoder_ms.serve``, ``voxel_encoders_ms.serve``, ``fuse_ms.serve``)
by hand on a host trace's ranges, adding up to the head."""
from __future__ import annotations

import json

import pytest
import torch

import bp_helpers as H

from bench_port import harness, spans
from bench_port.control import control_numbers
from bench_port.loops import loop_for
from bench_port.trace import Trace
from chip_smoke import tiny_dhd_m

SEED = 2 ** 31 + 977            # more than 32 signed bits hold
WORKLOAD = "dhd_m.stream"
PARTS = ("bev_encoder_ms.serve", "voxel_encoders_ms.serve", "fuse_ms.serve")


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def small_cell() -> harness.Cell:
    """``dhd_m.stream`` of ``BENCHMARK.json`` with its mix and limits, at
    :func:`tiny_dhd_m` in fp32, with the small cells' stretches and, as
    theirs, He's weight scale (at these widths the argmax is blind to the
    stream's history below it)."""
    spec = json.loads((H.ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(spec, WORKLOAD)
    assert cell.config["preset"] == "dhd_m"
    cell.config = H.config_file(tiny_dhd_m(), "dhd_tiny_stereo")
    cell.traffic = dict(cell.traffic, traced_items=2, detail_items=1,
                        image_pool=4, control_frames=12, weight_gain=2.0)
    return cell


def _number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
def test_a_run_gives_the_result_keys(trace):
    cell = small_cell()
    r = harness.run_cell(cell, SEED, 0.3, trace, H.CPU, log=H.quiet)
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == set(cell.limits)
    assert all(_number(c["value"]) for c in r["checks"].values())
    if trace:
        assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert set(PARTS) <= {m["name"] for m in cell.per_layer}
        assert r["device"]["busy_s"] > 0
    else:
        assert set(r["metrics"]) == {"frame_ms", "frame_p95_ms",
                                     "peak_mem_gb", "setup_s"}
    json.dumps(r)


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_a_planted_fault_reads_false(fault):
    cell = small_cell()
    r = harness.run_cell(cell, SEED, 0.3, False, H.CPU, fault=fault,
                         log=H.quiet)
    assert r["correct"] is False, r["checks"]


def test_the_fp8_control_reads_false():
    cell = small_cell()
    numbers = control_numbers(loop_for(cell.config, cell.traffic, SEED,
                                       H.CPU))
    assert harness.judge(numbers, cell.limits)[1] is False, numbers


class FakeTrace:
    kernel_s = Trace.kernel_s

    def __init__(self, kernels, host, items, ranges):
        self.kernels, self.host, self.items = kernels, host, items
        self.spans = ranges


# a frame of the device-only stretch, then one of the detail stretch: the
# program's spans (depth 0-2), the modules' ranges inside them on the host,
# and the device ranges of each, which hold only the kernels launched
# directly in them (the units' input copies, the slabs' collapse and the
# concatenations among them)
SPANS = [("forward", 0, 900, 950),
         ("forward", 0, 1000, 1100), ("head", 1, 1050, 1095),
         ("bev_encoder", 2, 1051, 1060), ("voxel_encoders", 2, 1060, 1080),
         ("fuse", 2, 1080, 1094)]
HOST = [(3000.0, 3100.0, "forward"), (3050.0, 3095.0, "head"),
        (3051.0, 3060.0, "bev_encoder"),
        (3052.0, 3059.0, "img_bev_encoder_backbone"),
        (3060.0, 3080.0, "voxel_encoders"),
        (3062.0, 3066.0, "img_voxel_encoder0"),
        (3067.0, 3072.0, "img_voxel_encoder1"),
        (3073.0, 3078.0, "img_voxel_encoder2"),
        (3080.0, 3094.0, "fuse"), (3081.0, 3086.0, "mix"),
        (3087.0, 3092.0, "occ_head")]
KERNELS = [(3500.0, 3510.0, "unet"),                    # bev encoder: 10
           (3511.0, 3512.0, "copy"), (3513.0, 3517.0, "slab0"),
           (3518.0, 3523.0, "slab1"), (3524.0, 3527.0, "slab2"),
           (3528.0, 3530.0, "cat"),                     # voxel: 1+4+5+3+2
           (3531.0, 3533.0, "cat"), (3534.0, 3541.0, "sfa"),
           (3542.0, 3546.0, "head"), (3547.0, 3548.0, "copy"),  # fuse: 14
           (3560.0, 3570.0, "argmax")]                  # the caller's
RANGES = {"img_bev_encoder_backbone": [(3500.0, 3510.0)],
          "voxel_encoders": [(3511.0, 3530.0)],
          "img_voxel_encoder0": [(3513.0, 3517.0)],
          "img_voxel_encoder1": [(3518.0, 3523.0)],
          "img_voxel_encoder2": [(3524.0, 3527.0)],
          "fuse": [(3531.0, 3548.0)], "mix": [(3534.0, 3541.0)],
          "occ_head": [(3542.0, 3546.0)]}


def _reader(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"m_{name.replace('.', '_')}",
        H.ROOT / "bench_port" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(device="cuda"):
    import types
    return types.SimpleNamespace(
        items=1, trace=FakeTrace([], [], 1, {}),
        detail=FakeTrace(KERNELS, HOST, 1, RANGES),
        loop=types.SimpleNamespace(device=torch.device(device)))


def test_the_head_splits_into_three_by_hand(monkeypatch):
    us = [(n, d, t0 * 1000, t1 * 1000) for n, d, t0, t1 in SPANS]
    monkeypatch.setattr(spans, "records", lambda: us)
    ctx = _ctx()
    parts = [_reader(n)(ctx) for n in PARTS]
    assert parts == pytest.approx([0.010, 0.015, 0.014])
    assert sum(parts) == pytest.approx(spans.kernel_ms(ctx, ("head",)))
    # off the card, or from a program that records no span: nothing
    assert all(_reader(n)(_ctx("cpu")) is None for n in PARTS)
    monkeypatch.setattr(spans, "records", lambda: None)
    assert all(_reader(n)(ctx) is None for n in PARTS)


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    """A program that records ``head`` but not its three parts: the
    readers return nothing, and do not raise."""
    older = [(n, d, t0 * 1000, t1 * 1000) for n, d, t0, t1 in SPANS[:3]]
    monkeypatch.setattr(spans, "records", lambda: older)
    ctx = _ctx()
    ctx.detail = FakeTrace(KERNELS, [h for h in HOST if h[2] not in (
        "bev_encoder", "voxel_encoders", "fuse")], 1, {
        k: v for k, v in RANGES.items()
        if k not in ("voxel_encoders", "fuse")})
    assert all(_reader(n)(ctx) is None for n in PARTS)
    assert spans.kernel_ms(ctx, ("head",)) is not None
