"""The yardstick's arithmetic at small shapes against hand counts: the
kernels' least times, the model-FLOP counter, and the trace readers."""
from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import types

import pytest
import torch

import bp_helpers as H

from bench_port import bounds, flops
from bench_port.reference.config import config_from_dict

METRICS = H.ROOT / "bench_port" / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name.replace('.', '_')}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def served_config(name):
    """A configuration of ``BENCHMARK.json`` as the cells run it."""
    path = H.ROOT / "bench_port" / "configs" / f"{name}.json"
    return config_from_dict(json.loads(path.read_text())["model"])


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
    # a launch moving m rows of c and norming r of them; the patch embed
    # 48 rows x 4; stage 0 (4x6 tokens, whole windows of 2) a window and a
    # residual launch over 48 x 4, its merge 12 rows x 16; stage 1 (2x3
    # tokens, padded to 2x4: 16 window rows) the two launches over 12 x 8
    # and its out norm
    def one(m, r, c):
        return max((2 * m * c + 8 * c) / 3.35e12, 8 * r * c / 67e12)
    cfg = dataclasses.replace(small_swin(), stereo=False,
                              backbone_out_indices=(1,))
    want = one(96, 48, 4) + one(48 + 48, 48, 4) + one(4 * 48, 48, 4) \
        + one(24, 12, 16) + one(12 + 16, 12, 8) + one(4 * 12, 12, 8) \
        + one(24, 12, 8)
    assert reader("b5_roofline.serve").frame_least_s(cfg) == \
        pytest.approx(want)


@pytest.mark.parametrize("size, tokens, window_rows", [
    ((16, 16), 4 * 4, 4 * 4), ((20, 28), 5 * 7, 6 * 8)],
    ids=["whole", "pads"])
def test_b5_window_launch_writes_the_padded_map(size, tokens, window_rows):
    # one stage of one block, two cameras, windows of 2: the window launch
    # reads the tokens and writes the map padded to whole windows, zero
    # rows included; the residual launch reads x and the attention's
    # rows of the tokens and writes the sum and the norm
    base = small_swin()
    cfg = dataclasses.replace(
        base, vt=dataclasses.replace(base.vt, input_size=size),
        swin_depths=(1,), swin_num_heads=(1,), stereo=False,
        backbone_out_indices=(0,))
    mod = reader("b5_roofline.serve")
    rows = 2 * tokens
    assert mod.frame_launches(cfg) == [
        ("plain", 2 * rows, rows, 4),
        ("window", rows + 2 * window_rows, rows, 4),
        ("residual", 4 * rows, rows, 4),
        ("plain", 2 * rows, rows, 4)]
    assert mod.launch_bytes(rows + 2 * window_rows, 4) == \
        2 * (rows + 2 * window_rows) * 4 + 2 * 4 * 4


def test_b5_counts_dhd_ls_fused_launches():
    # PERF.md: 6 plain and 24 + 24 fused launches a DHD-L frame, the fused
    # ones ~3.3 GB
    mod = reader("b5_roofline.serve")
    cfg = served_config("dhd_l")
    kinds = collections.Counter(k for k, *_ in mod.frame_launches(cfg))
    assert kinds == {"plain": 6, "window": 24, "residual": 24}
    fused = sum(mod.launch_bytes(m, c)
                for kind, m, _, c in mod.frame_launches(cfg)
                if kind != "plain")
    assert 3.0e9 <= fused <= 3.6e9
    assert 1.0e-3 <= mod.frame_least_s(cfg) <= 1.25e-3


def test_b5_reads_only_the_launches_it_counts():
    mod = reader("b5_roofline.serve")
    cfg = dataclasses.replace(small_swin(), stereo=False,
                              backbone_out_indices=(1,))
    least = mod.frame_least_s(cfg)
    n = len(mod.frame_launches(cfg))
    assert n == 7
    step = 1e6 * least / n          # us a launch, a frame's least time
    tr = FakeTrace([(i * 10.0, i * 10.0 + 4 * step, "layer_norm_kernel")
                    for i in range(2 * n)], 1.0, 2)
    ctx = types.SimpleNamespace(trace=tr, items=2, cfg=cfg)
    assert mod.read(ctx) == pytest.approx(25.0)
    tr.kernels = tr.kernels[1:]
    assert mod.read(ctx) is None
    assert mod.read(types.SimpleNamespace(
        trace=FakeTrace([], 1.0, 2), items=2, cfg=cfg)) is None


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


@pytest.mark.parametrize("pool", [False, True], ids=["no_pool", "pool"])
def test_unet_epilogue_launch_by_hand(pool):
    # a BatchNorm and ReLU at 16x16 rows of 8 in bf16: x read, y written,
    # four fp32 vectors of 8; with the pool also its 8x8 rows written
    mod = reader("unet_epilogue_roofline.serve")
    pooled = 8 * 8 if pool else 0
    assert mod.bn_bytes(256, 8, 2, pooled) == \
        2 * 256 * 8 + 2 * 256 * 8 + 2 * pooled * 8 + 16 * 8
    # the encoder's second launch at the top level is the one that pools
    first, second = mod.unet_launch_bytes(16, 16, 8, 2)[:2]
    assert second - first == 2 * 8 * 8 * 8


def test_unet_epilogue_bound_by_hand():
    # one UNet at 16x16, base 8, bf16; a level's rows and channels:
    # (256, 8), (64, 16), (16, 32), (4, 64), (1, 128)
    def bn(rows, c, pooled=0):
        return 2 * (2 * rows + pooled) * c + 16 * c

    def level(rows, c, below):
        # two BatchNorms, the second pooling; the transposed conv's output
        # (4 rows for each row below) and its bias placed; two BatchNorms
        return (bn(rows, c) + bn(rows, c, rows // 4)
                + 2 * (4 * below + 1 + rows) * c + 2 * bn(rows, c))
    want = (level(256, 8, 64) + level(64, 16, 16) + level(16, 32, 4)
            + level(4, 64, 1) + 2 * bn(1, 128))
    mod = reader("unet_epilogue_roofline.serve")
    got = mod.unet_launch_bytes(16, 16, 8, 2)
    assert len(got) == 22 and sum(got) == want == 91760


@pytest.mark.parametrize("name, unets", [
    ("dhd_s", 3), ("dhd_m", 4), ("dhd_l", 3)])
def test_unet_epilogue_launches_a_frame(name, unets):
    # 22 a UNet: the three slab encoders, and DHD-M's BEV encoder; a
    # served UNet's bytes, ~0.0297 ms at the HBM peak (PERF.md)
    mod = reader("unet_epilogue_roofline.serve")
    cfg = served_config(name)
    assert mod.unets(cfg) == unets
    assert mod.frame_launches(cfg) == 22 * unets
    assert mod.frame_least_s(cfg, 2) / unets == pytest.approx(2.97e-5,
                                                              rel=0.01)


def test_unet_epilogue_reads_only_its_kernels():
    mod = reader("unet_epilogue_roofline.serve")
    cfg = served_config("dhd_s")
    least = mod.frame_least_s(cfg, 2)
    step = 1e6 * least / 66
    names = 54 * ["unet_bn_relu_kernel"] + 12 * ["unet_up_place_kernel"]
    kernels = [(i * 10.0, i * 10.0 + 2 * step, names[i % 66])
               for i in range(2 * 66)]
    loop = types.SimpleNamespace(dtype=torch.bfloat16)
    tr = FakeTrace(kernels + [(5000.0, 5100.0, "layer_norm_kernel")],
                   1.0, 2)
    ctx = types.SimpleNamespace(trace=tr, items=2, cfg=cfg, loop=loop)
    assert mod.read(ctx) == pytest.approx(50.0)
    # no epilogue kernel in the trace, or launches it does not count
    tr.kernels = [k for k in tr.kernels if k[2] not in mod.KERNELS]
    assert mod.read(ctx) is None
    tr.kernels = kernels[:-1]
    assert mod.read(ctx) is None
