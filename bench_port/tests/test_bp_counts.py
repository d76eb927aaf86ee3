"""The yardstick's arithmetic at small shapes against hand counts: the
kernels' least times, the model-FLOP counter, and the trace readers."""
from __future__ import annotations

import dataclasses
import importlib.util
import types

import pytest
import torch

import bp_helpers as H

from bench_port import bounds, flops

METRICS = H.ROOT / "bench_port" / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name.replace('.', '_')}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_swin():
    """Two stages over 2 cameras of 16x24 images: 4x6 tokens, then 2x3,
    window 2, embed 4, heads 1 and 2, one block a stage."""
    cfg = H.get_config("dhd_tiny_stereo")
    return dataclasses.replace(
        cfg, num_cams=2, vt=dataclasses.replace(cfg.vt, input_size=(16, 24)),
        backbone="swin_base", swin_embed_dims=4, swin_depths=(1, 1),
        swin_num_heads=(1, 2), swin_window=2, stereo=True)


def test_least_time_takes_the_larger_bound():
    assert bounds.least_s(3.35e12, 0.0, 1.0) == pytest.approx(1.0)
    assert bounds.least_s(0.0, 989e12, bounds.BF16_FLOP_PER_S) == \
        pytest.approx(1.0)
    assert bounds.share(1.0, 4.0) == pytest.approx(25.0)


def test_b4_bound_by_hand():
    # stage 0: 4x6 tokens, 6 windows an image of N=4, 12 windows, C=4,
    # 1 head; stage 1: 2x3 tokens padded to 2x4, 2 windows an image, 4
    # windows, C=8, 2 heads; one unshifted block each (no mask)
    hb = 3.35e12
    s0 = max(2 * (12 * 4 * 12 + 12 * 4 * 4 + 1 * 16) / hb,
             12 * 1 * 4 * 16 * 4 / 989e12)
    s1 = max(2 * (4 * 4 * 24 + 4 * 4 * 8 + 2 * 16) / hb,
             4 * 2 * 4 * 16 * 4 / 989e12)
    assert reader("b4_roofline.serve").frame_least_s(small_swin()) == \
        pytest.approx(s0 + s1)


def test_b5_bound_by_hand():
    # patch embed 48 rows x 4; stage 0 two norms of 48 x 4, its merge 12
    # rows x 16; stage 1 two norms of 12 x 8 and its out norm
    def one(rows, c):
        return max((4 * rows * c + 8 * c) / 3.35e12, 8 * rows * c / 67e12)
    cfg = dataclasses.replace(small_swin(), stereo=False,
                              backbone_out_indices=(1,))
    want = one(48, 4) + 2 * one(48, 4) + one(12, 16) + 2 * one(12, 8) \
        + one(12, 8)
    assert reader("b5_roofline.serve").frame_least_s(cfg) == \
        pytest.approx(want)


def test_flop_counter_counts_a_conv(tmp_path, monkeypatch):
    monkeypatch.setattr(flops, "CACHE", tmp_path)
    conv = torch.nn.Conv2d(3, 5, 3, padding=1, bias=False)
    x = torch.randn(2, 3, 7, 9)
    flops.count_into("k", lambda: conv(x), scale=3)
    assert flops.cached("k") == 3 * 2 * (2 * 5 * 7 * 9 * 3 * 3 * 3)
    assert flops.cached("other") is None


class FakeTrace:
    def __init__(self, kernels, window_s, items, spans=None):
        self.kernels, self.window_s, self.items = kernels, window_s, items
        self.spans = spans or {}

    from bench_port.trace import Trace as _T
    busy_intervals = _T.busy_intervals
    busy_s = _T.busy_s
    kernel_s = _T.kernel_s
    launches = _T.launches
    range_kernel_s = _T.range_kernel_s

    @property
    def _starts(self):
        return [k[0] for k in self.kernels]


def test_trace_readers_by_hand():
    # two frames; kernels at [0, 10), [5, 20), [30, 40) us; the frame's
    # range spans [0, 25) on the device
    tr = FakeTrace([(0.0, 10.0, "a"), (5.0, 20.0, "mghs_pool_kernel"),
                    (30.0, 40.0, "elementwise_kernel")], 80e-6, 2,
                   {"img_backbone": [(0.0, 25.0)]})
    # the untraced window: 40 us a frame, against 15 us busy a frame
    ctx = types.SimpleNamespace(trace=tr, detail=tr, items=2, kind="serve",
                                item_s=40e-6, loop=types.SimpleNamespace(
                                    device=torch.device("cuda")))
    assert tr.busy_s == pytest.approx(30e-6)
    assert reader("idle_share.serve").read(ctx) == pytest.approx(62.5)
    assert reader("busy_ms.serve").read(ctx) == pytest.approx(0.015)
    assert reader("launches_per_frame").read(ctx) == 1.5
    assert reader("backbone_ms.serve").read(ctx) == pytest.approx(0.0125)
    assert reader("view_transform_ms.serve").read(ctx) is None
    assert reader("elementwise_share.train").read(ctx) == \
        pytest.approx(100 * 10 / 35)
    ctx.model_flops, ctx.item_s = (lambda: 989e12 * 0.5), 1.0
    assert reader("mfu.serve").read(ctx) == pytest.approx(50.0)


def test_b1_bound_by_hand():
    from bench_port.loops import ServeLoop
    cfg = H.get_config("dhd_tiny")
    cell = H.small_cell("dhd_s.serve", precision="bfloat16")
    loop = ServeLoop(cell.config, cell.traffic, 3, H.CPU)
    vt = cfg.vt
    mod = reader("b1_roofline.serve")
    n_valid = mod.points_in_grid(types.SimpleNamespace(cfg=cfg, loop=loop))
    assert 0 < n_valid <= cfg.num_cams * vt.D * vt.feat_size[0] \
        * vt.feat_size[1]
    fh, fw = vt.feat_size
    pillars = vt.x.size * vt.y.size
    nbytes = (2 * (pillars * 16 * 16 + pillars * 16
                   + 6 * fh * fw * (vt.D + 16 + 3))
              + 8 * n_valid + 4 * (pillars + 1))
    want = max(nbytes / 3.35e12, 2 * n_valid * 16 / 67e12)
    tr = FakeTrace([(0.0, 1e6 * want * 4, "mghs_pool_kernel")], 1.0, 2)
    ctx = types.SimpleNamespace(trace=tr, items=2, cfg=cfg, loop=loop)
    assert mod.read(ctx) == pytest.approx(50.0)
