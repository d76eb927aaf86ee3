"""CUDA graphs of the served frame (``dhd_tpu_torch/models/graphs.py``).

When graphs engage is a pure function, tested here case by case.  The
capture, replay and copy rules are tested twice: on the CPU, where a
stand-in graph replays by running the captured call again on the
captured inputs and writing its outputs where the capture's lie (the
memory rule of a CUDA graph: a replay overwrites its outputs in place),
and on the card (``cuda``-marked) with ``torch.cuda.CUDAGraph``.  Served
frames from graphs equal eager frames of the same weights; a stale cache
gets its own answer; outputs held across frames keep their values; a new
plan or newly loaded weights capture anew; hooks and spans still open
around each replay; the counters read one capture a unit and a replay a
unit for each later frame."""
import contextlib
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dhd_tpu_torch import profiling
from dhd_tpu_torch.config import get_config
from dhd_tpu_torch.data import synthetic_batch
from dhd_tpu_torch.models import (build_batch_pool_plan, build_model,
                                  build_stream_cv_static,
                                  build_stream_pool_plan, graphs)

UNITS = {
    "dhd_tiny": ["img_backbone", "img_neck", "img_view_transformer",
                 "img_bev_encoder_backbone", "img_bev_encoder_neck",
                 "img_voxel_encoder0", "img_voxel_encoder1",
                 "img_voxel_encoder2", "mix", "occ_head"],
    "dhd_micro_stereo": [
        "geometry", "img_backbone", "img_neck", "cost_volume",
        "img_view_transformer", "pre_process_net", "pre_process_net_3d",
        "history_warp", "img_bev_encoder_backbone",
        "img_bev_encoder_neck", "img_voxel_encoder0", "img_voxel_encoder1",
        "img_voxel_encoder2", "mix", "occ_head"]}
FRAMES = 5
COUNTERS = ("graph_captures", "graph_replays", "graph_eager_calls")
KW = dict(training=False, grad_enabled=False, device=torch.device("cuda"),
          compiling=False, batch={"pool_plan": 1, "cv_static": 2},
          rig=("pool_plan",), cache={"bev": 3})


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: under the test lane's parallel workers the tiny
    models' small ops otherwise stall on the other workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("call,change,want", [
    ("frame", {}, True),
    ("stream", {}, True),
    ("stream", dict(rig=("pool_plan", "cv_static")), True),
    ("frame", dict(training=True), False),
    ("frame", dict(grad_enabled=True), False),
    ("frame", dict(batch={}), False),
    ("stream", dict(batch={"pool_plan": 1}, rig=("pool_plan", "cv_static")),
     False),
    ("frame", dict(rig=()), False),
    ("stream", dict(cache={}), False),
    ("stream", dict(cache={"stereo_feat": 1}), False),
    ("frames", {}, False),
    ("frame", dict(compiling=True), False),
    ("frame", dict(device=torch.device("cpu")), False),
], ids=["eval-plan-cuda", "stream-filled-cache", "stereo-rig",
        "train-mode", "autograd", "no-plan", "no-cv-static", "plain-path",
        "bootstrap", "cache-without-grids", "f-frame", "compiling", "cpu"])
def test_when_graphs_engage(call, change, want):
    assert graphs.engages(call, **dict(KW, **change)) is want


def test_compiling_covers_export(monkeypatch):
    assert not graphs.compiling()
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    assert graphs.compiling()


def test_an_unknown_call_raises():
    with pytest.raises(ValueError):
        graphs.engages("step", **KW)


def test_signature_holds_shapes_and_the_plans_storage():
    plan = {"t": torch.zeros(3), "n": 2}
    batch = {"imgs": torch.zeros(1, 2), "pool_plan": plan}
    key = graphs.signature(batch, ("pool_plan",), None)
    assert key == graphs.signature(dict(batch, imgs=torch.ones(1, 2)),
                                   ("pool_plan",), None)
    for other in (dict(batch, imgs=torch.zeros(1, 3)),
                  dict(batch, imgs=torch.zeros(1, 2, dtype=torch.bfloat16)),
                  dict(batch, pool_plan=dict(plan, t=plan["t"].clone()))):
        assert graphs.signature(other, ("pool_plan",), None) != key
    assert graphs.signature(batch, ("pool_plan",), {"bev": torch.zeros(2)}) \
        != key


class _StandIn:
    """A CUDA graph's stand-in on the CPU: a replay runs the captured call
    again on the captured inputs and writes its outputs where the
    capture's lie."""

    def __init__(self, run, out):
        self.run_, self.out = run, out

    def replay(self):
        for have, new in zip(graphs._tensors(self.out),
                             graphs._tensors(self.run_())):
            have.copy_(new)


def _stand_in_record(run, frame_graphs):
    out = run()
    return _StandIn(run, out), out


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def dev(request, monkeypatch):
    """The device the graphs run on: the CPU with stand-in graphs that
    engage as they would on the card, or the card itself."""
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: runs on the chip")
        return torch.device("cuda")
    engages = graphs.engages
    monkeypatch.setattr(graphs, "_record", _stand_in_record)
    monkeypatch.setattr(graphs, "engages", lambda call, **kw: engages(
        call, **dict(kw, device=torch.device("cuda"))))
    return torch.device("cpu")


def _frames(cfg, dev, n=FRAMES, seed=0):
    """``n`` frames of one rig: new images each frame, and for a stream
    the ego 0.5 m further along each frame; tensors on ``dev``."""
    batch = synthetic_batch(cfg, 1, seed=seed, with_gt=False)
    rng = np.random.default_rng(seed + 50)
    frames = []
    for k in range(n):
        if cfg.temporal:
            f = {key: batch[key] if key == "bda" else batch[key][:, 0]
                 for key in ("sensor2ego", "ego2global", "intrins",
                             "post_rots", "post_trans", "bda")}
            f["ego2global"] = f["ego2global"].copy()
            f["ego2global"][..., 0, 3] += 0.5 * k
            shape = batch["imgs"][:, 0].shape
        else:
            f = {key: v for key, v in batch.items() if key != "imgs"}
            shape = batch["imgs"].shape
        f["imgs"] = rng.normal(0, 1, shape).astype(np.float32)
        frames.append({key: torch.as_tensor(v, device=dev)
                       for key, v in f.items()})
    return frames


def _rig(cfg, frame, dev):
    if not cfg.temporal:
        return {"pool_plan": build_batch_pool_plan(cfg, frame, device=dev)}
    return {"pool_plan": build_stream_pool_plan(cfg, frame, device=dev),
            "cv_static": build_stream_cv_static(cfg, frame, device=dev)}


class _Server:
    """A model serving frames of one rig, as the benchmark's loops do."""

    def __init__(self, cfg, dev, model=None):
        self.cfg = cfg
        self.model = model or build_model(
            cfg, device=dev, generator=torch.Generator().manual_seed(1))
        self.cache = {}

    def __call__(self, frame, cache=None):
        with torch.no_grad():
            if not self.cfg.temporal:
                return self.model(frame)
            out, self.cache = self.model(
                frame, cache=self.cache if cache is None else cache)
            return out


def _pair(preset, dev):
    """A served model, an eager twin with its weights (whose frames never
    engage graphs), frames and rig."""
    cfg = get_config(preset)
    served = _Server(cfg, dev)
    eager = _Server(cfg, dev, build_model(cfg, device=dev))
    eager.model.load_state_dict(served.model.state_dict())
    eager.model._served = lambda *a, **kw: contextlib.nullcontext()
    frames = _frames(cfg, dev)
    return served, eager, frames, _rig(cfg, frames[0], dev)


def _counters():
    c = profiling.counters()
    return {k: c.get(k, 0) for k in COUNTERS}


def _same(a, b, dev):
    # the CPU replays the same arithmetic; the card's eager and graphed
    # launches are the same kernels, B1 summing by atomics
    if dev.type == "cpu":
        assert torch.equal(a, b)
    else:
        assert (a - b).abs().max() <= 1e-5 * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("preset", list(UNITS))
def test_replayed_frames_equal_eager_frames(preset, dev):
    served, eager, frames, rig = _pair(preset, dev)
    temporal = served.cfg.temporal
    if temporal:                    # the bootstrap frames, not served
        served(dict(frames[0], **rig))
        eager(dict(frames[0], **rig))
    profiling.reset()
    for k, frame in enumerate(frames):
        got = served(dict(frame, **rig))
        want = eager(dict(frame, **rig))
        for key in ("occ_logits", "occ_logits_flat", "depth", "height"):
            _same(got[key], want[key], dev)
        if temporal:
            for key in served.cache:
                _same(served.cache[key], eager.cache[key], dev)
    units = UNITS[preset]
    assert [u.name for u in served.model._graphs._units] == units
    assert _counters() == {"graph_captures": len(units),
                           "graph_replays": len(units) * (FRAMES - 2),
                           "graph_eager_calls": len(units)}


def test_a_stale_cache_gets_its_own_answer(dev):
    """A caller that hands in an older cache (the benchmark's
    ``state_unchanged`` fault) gets the eager answer for that cache."""
    served, eager, frames, rig = _pair("dhd_micro_stereo", dev)
    served(dict(frames[0], **rig))
    old = dict(served.cache)
    for frame in frames[1:4]:
        served(dict(frame, **rig))
    eager(dict(frames[0], **rig))
    stale = eager.cache
    before = _counters()["graph_replays"]
    got = served(dict(frames[4], **rig), cache=old)
    want = eager(dict(frames[4], **rig), cache=stale)
    assert _counters()["graph_replays"] > before
    _same(got["occ_logits"], want["occ_logits"], dev)


@pytest.mark.parametrize("preset", list(UNITS))
def test_outputs_held_across_frames_keep_their_values(preset, dev):
    served, _, frames, rig = _pair(preset, dev)
    held = []
    for frame in frames:
        out = served(dict(frame, **rig))
        held.append({k: (v, v.clone()) for k, v in out.items()})
        if served.cfg.temporal:
            held.append({k: (v, v.clone()) for k, v in served.cache.items()})
    assert _counters()["graph_replays"] > 0
    for outs in held:
        for k, (kept, at_the_time) in outs.items():
            assert torch.equal(kept, at_the_time), k


@pytest.mark.parametrize("preset", list(UNITS))
def test_a_new_plan_or_new_weights_capture_anew(preset, dev):
    served, _, frames, rig = _pair(preset, dev)
    n = len(UNITS[preset])
    for frame in frames[:3]:
        served(dict(frame, **rig))
    profiling.reset()
    fresh = _rig(served.cfg, frames[0], dev)        # new storage
    for frame in frames[:3]:
        served(dict(frame, **fresh))
    assert _counters() == {"graph_captures": n, "graph_replays": n,
                           "graph_eager_calls": n}
    profiling.reset()
    served.model.load_state_dict(served.model.state_dict())
    for frame in frames[:3]:
        served(dict(frame, **fresh))
    assert _counters() == {"graph_captures": n, "graph_replays": n,
                           "graph_eager_calls": n}


def test_moved_weights_fall_back_then_capture_anew(dev):
    """A weight given new storage behind the model's back: its unit and
    the rest of that frame run eagerly, with the new weight; the next
    frames warm up and capture anew."""
    served, eager, frames, rig = _pair("dhd_tiny", dev)
    for frame in frames[:3]:
        served(dict(frame, **rig))
    for model in (served.model, eager.model):
        w = next(model.mix.parameters())
        w.data = w.data * 0.5
    profiling.reset()
    _same(served(dict(frames[3], **rig))["occ_logits"],
          eager(dict(frames[3], **rig))["occ_logits"], dev)
    assert _counters() == {"graph_captures": 0, "graph_replays": 8,
                           "graph_eager_calls": 2}     # mix and occ_head
    for frame in frames[:3]:
        served(dict(frame, **rig))
    assert _counters() == {"graph_captures": 10, "graph_replays": 18,
                           "graph_eager_calls": 12}


def test_hooks_and_spans_open_around_each_replay(dev):
    """A forward hook on each unit module (what a trace's module ranges
    are) fires once a frame, replayed or not, and under a profiler a
    replayed frame records its spans as an eager one does."""
    served, _, frames, rig = _pair("dhd_micro_stereo", dev)
    fired = []
    for name, child in served.model.named_children():
        child.register_forward_hook(
            lambda mod, args, out, name=name: fired.append(name))
    served(dict(frames[0], **rig))
    for frame in frames[1:4]:
        served(dict(frame, **rig))
    assert _counters()["graph_replays"] > 0
    per_frame = len(fired) // 4
    assert fired == fired[:per_frame] * 4
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        served(dict(frames[4], **rig))
    assert [s[0] for s in profiling.spans()] == [
        "forward", "encode", "cost_volume", "view_transform", "pre_process",
        "history_warp", "head", "bev_encoder", "voxel_encoders", "fuse"]
    assert _counters()["graph_replays"] == len(UNITS["dhd_micro_stereo"])


def test_a_copied_model_captures_its_own(dev):
    served, _, frames, rig = _pair("dhd_tiny", dev)
    for frame in frames[:3]:
        served(dict(frame, **rig))
    twin = _Server(served.cfg, dev, copy.deepcopy(served.model))
    assert twin.model._graphs._units == []
    _same(twin(dict(frames[3], **rig))["occ_logits"],
          served(dict(frames[3], **rig))["occ_logits"], dev)


def test_unengaged_calls_count_nothing(dev):
    """Frames planned in the call, a train-mode step and the F-frame
    forward run eagerly and count no graph call."""
    cfg = get_config("dhd_micro_stereo")
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(1))
    frames = _frames(cfg, dev, n=3)
    profiling.reset()
    cache = {}
    with torch.no_grad():
        for frame in frames:
            _, cache = model(frame, cache=cache)
        model(synthetic_batch(cfg, 1, seed=3, with_gt=False))
    model.train()
    model(synthetic_batch(cfg, 1, seed=3, with_gt=False))
    assert _counters() == dict.fromkeys(COUNTERS, 0)
    assert model._graphs._units == []


def test_the_benchmark_cli_prints_the_graph_counters(capsys):
    """``cli/benchmark``'s ``set-up:`` line counts the served frames'
    graph captures, replays and eager unit calls: none on the CPU."""
    from dhd_tpu_torch.cli.benchmark import main
    profiling.reset()
    assert main(["--preset", "dhd_micro_stereo", "--what", "stream",
                 "--fp32", "--device", "cpu", "--iters", "2"]) == 0
    line = next(s for s in capsys.readouterr().out.splitlines()
                if s.startswith("set-up:"))
    assert line.endswith("graph captures 0, replays 0, eager calls 0")
