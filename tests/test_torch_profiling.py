"""The port's own spans, launch marks and counters
(``dhd_tpu_torch.profiling``) on the CPU at tiny sizes: a served frame
records nothing without a profiler; under one, DHD-S's and the stereo
model's frames record their named spans, nested, on the profiler's own
clock; set-up spans and the kernel loader's counters are recorded without
a profiler; an exported program holds no profiler op; spans off cost a
bool check.  On the card (``cuda``-marked) the launch marks put the
program's clock on a device trace's timeline, and idle gaps planted on the
host are recovered as long as, and where, they were planted."""
import statistics
import time
import types
from collections import Counter, defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dhd_tpu_torch import profiling
from dhd_tpu_torch.cli import export
from dhd_tpu_torch.config import get_config
from dhd_tpu_torch.data import synthetic_batch
from dhd_tpu_torch.models import (build_batch_pool_plan, build_model,
                                  build_stream_cv_static,
                                  build_stream_pool_plan)
from dhd_tpu_torch.ops import cuda_build

STREAM_KEYS = ("imgs", "sensor2ego", "ego2global", "intrins", "post_rots",
               "post_trans", "bda")
# a served frame's spans, (name, depth), in the order they open
SERVED = {
    "dhd_tiny": [("forward", 0), ("encode", 1), ("view_transform", 1),
                 ("head", 1), ("bev_encoder", 2), ("voxel_encoders", 2),
                 ("fuse", 2)],
    "dhd_tiny_stereo": [
        ("forward", 0), ("encode", 1), ("cost_volume", 1),
        ("view_transform", 1), ("pre_process", 1), ("history_warp", 1),
        ("head", 1), ("bev_encoder", 2), ("voxel_encoders", 2),
        ("fuse", 2)]}
CLOCK_US = 50.0
# idle gaps planted on the card: their length; the anchored clock's error
# over a stretch (up to 0.14 ms in the median on the H100 it was measured
# on, as a trace's device times stand off the host's by a few percent in
# some stretches); the host's dispatch of an aten op (52-72 us there)
PLANT_S = 2e-3
PLANT_US = 250.0
DISPATCH_US = 150.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: under the test lane's parallel workers the tiny
    models' small ops otherwise stall on the other workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _server(preset, dev=torch.device("cpu"), cached=True):
    """The preset's model and a served frame: ``step()`` serves one.  With
    ``cached`` the frame carries the rig's cached plans (on the card such
    frames replay CUDA graphs after two); without, each frame plans in the
    call and runs eagerly."""
    cfg = get_config(preset)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    batch = synthetic_batch(cfg, 1, seed=0, with_gt=False)
    if not cfg.temporal:
        frame = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if cached:
            frame["pool_plan"] = build_batch_pool_plan(cfg, frame, device=dev)
        return model, frame, lambda: model(frame)
    frame = {k: torch.as_tensor(batch[k] if k == "bda" else batch[k][:, 0],
                                device=dev) for k in STREAM_KEYS}
    if cached:
        frame["pool_plan"] = build_stream_pool_plan(cfg, frame, device=dev)
        frame["cv_static"] = build_stream_cv_static(cfg, frame, device=dev)
    state = {"cache": {}}

    def step():
        out, state["cache"] = model(frame, cache=state["cache"])
        return out
    step()                          # the bootstrap frame: no history
    return model, frame, step


@pytest.fixture(scope="module")
def servers():
    return {p: _server(p) for p in SERVED}


@pytest.mark.parametrize("preset", list(SERVED))
def test_no_profiler_records_no_span(servers, preset):
    _, _, step = servers[preset]
    profiling.reset()
    with torch.no_grad():
        step()
    assert profiling.spans() == [] and profiling.launch_marks() == []


@pytest.mark.parametrize("preset", list(SERVED))
def test_served_spans_nest_on_the_profilers_clock(servers, preset):
    """Under ``torch.profiler`` a frame records its named spans, each
    inside its parent; each span maps onto its ``record_function`` event
    by one offset, within CLOCK_US.  A span's times are taken just outside
    its range's calls, so the host's delays between them only widen the
    gaps: each span's gaps are the least over three frames (the first
    frame of the four pays each name's first range)."""
    _, _, step = servers[preset]
    profiling.reset()
    frames = 4
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(frames):
            step()
    spans = profiling.spans()
    n = len(SERVED[preset])
    assert [(s[0], s[1]) for s in spans] == frames * SERVED[preset]
    for f in range(frames):
        frame = spans[f * n:(f + 1) * n]
        for i, (name, depth, t0, t1) in enumerate(frame):
            assert t0 < t1
            if depth:
                parent = next(s for s in reversed(frame[:i]) if s[1] < depth)
                assert parent[2] <= t0 and t1 <= parent[3], (name, parent[0])
    assert profiling.launch_marks() == []     # the CPU runs no kernel

    ranges = defaultdict(list)
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.is_user_annotation:
            ranges[e.name].append(e)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    seen = Counter()
    gaps = defaultdict(list)        # span's place in its frame: its gaps
    for k, (name, _, t0, t1) in enumerate(spans):
        e = ranges[name][seen[name]]
        seen[name] += 1
        if k >= n:
            gaps[k % n].append(
                ((t0 - start_ns) / 1e3 - e.time_range.start,
                 (t1 - start_ns) / 1e3 - e.time_range.end))
    # the least gap of each: the latest start, the earliest end
    offsets = [o for g in gaps.values()
               for o in (max(a for a, _ in g), min(b for _, b in g))]
    # the best one offset is the middle of their range
    assert max(offsets) - min(offsets) <= 2 * CLOCK_US, {
        spans[k][0]: [(round(a, 1), round(b, 1)) for a, b in g]
        for k, g in gaps.items()}


def _fake_nvcc(tmp_path):
    """A stand-in for nvcc that writes an empty file where ``-o`` says."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\n'
                    'done\n')
    nvcc.chmod(0o755)
    return str(nvcc)


def test_setup_spans_and_kernel_counters_without_a_profiler(tmp_path,
                                                            monkeypatch):
    profiling.reset()
    cfg = get_config("dhd_tiny_stereo")
    build_model(cfg, device="cpu")
    batch = synthetic_batch(cfg, 1, seed=0, with_gt=False)
    frame = {k: batch[k] if k == "bda" else batch[k][:, 0]
             for k in STREAM_KEYS}
    build_stream_pool_plan(cfg, frame, device="cpu")
    build_stream_cv_static(cfg, frame, device="cpu")
    # the kernel loader, with a stand-in compiler and library
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    assert cuda_build.load("mghs_pool").endswith(".so")
    cuda_build.load("mghs_pool")
    spans = profiling.spans()
    assert [s[0] for s in spans] == [
        "setup.init_weights", "setup.pool_plan", "setup.cv_static",
        "setup.kernel_load"]
    assert all(d == 0 and t0 < t1 for _, d, t0, t1 in spans)
    c = profiling.counters()
    assert (c["kernel_builds"], c["kernel_loads"]) == (1, 1)
    assert profiling.kernel_launches() == dict.fromkeys(
        profiling.KERNEL_WRAPPERS, 0)


def test_an_export_under_the_profiler_holds_no_profiler_op(servers):
    model, frame, _ = servers["dhd_tiny"]
    keys = sorted(k for k in frame if k != "pool_plan")
    inputs = export.batch_inputs({k: frame[k] for k in keys}, keys, "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        ep, _ = export.export_program(model, inputs, bake=False)
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert targets and not [t for t in targets
                            if "profiler" in t or "record_function" in t]


def test_ten_thousand_spans_off_take_under_5_ms():
    """The spans' own cost, ten to a loop pass: the thread's CPU time, the
    least of ten tries, which the other processes of a loaded machine add
    least to."""
    profiling.reset()
    span = profiling.span
    best = float("inf")
    for _ in range(10):
        t0 = time.thread_time()
        for _ in range(1000):
            with span("a"), span("b"), span("c"), span("d"), span("e"):
                pass
            with span("f"), span("g"), span("h"), span("i"), span("j"):
                pass
        best = min(best, time.thread_time() - t0)
    assert best < 5e-3 and profiling.spans() == []


@pytest.mark.cuda
def test_launch_anchors_place_each_frame_on_the_card():
    """24 streamed tiny stereo frames under a device-only profiler, served
    without the rig's cached plans, so eagerly (a replayed CUDA graph makes
    no launch mark): each mark falls inside a ``forward`` span, every frame
    marks the same launches, and the trace's clock put on the program's
    (``bench_port/spans.py:clock``, an anchor a frame) places each marked
    kernel's start inside its frame: after the frame's ``forward`` span
    opens, before the next one does.  (No offset holds a stretch to the
    us: the trace's device clock drifts against the program's by up to
    milliseconds, and within a frame by up to 0.15 ms on the H100 this
    was written on.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the chip")
    from bench_port.spans import clock
    from bench_port.trace import traced

    dev = torch.device("cuda")
    _, _, step = _server("dhd_tiny_stereo", dev, cached=False)
    with torch.no_grad():
        for _ in range(3):
            step()
        profiling.reset()

        def run():
            for _ in range(24):
                step()["occ_logits"].argmax(-1).cpu()
        tr = traced(run, 24)
    spans = [(n, d, t0 / 1e3, t1 / 1e3) for n, d, t0, t1 in profiling.spans()]
    forwards = [s for s in spans if s[0] == "forward"]
    marks = [(k, t / 1e3) for k, t in profiling.launch_marks()]
    assert len(forwards) == 24 and marks, (len(forwards), len(marks))
    per_frame = [[m for m in marks if f[2] <= m[1] <= f[3]]
                 for f in forwards]
    assert sum(map(len, per_frame)) == len(marks), \
        [m for m in marks if not any(f[2] <= m[1] <= f[3] for f in forwards)]
    kinds = {tuple(k for k, _ in f) for f in per_frame}
    assert len(kinds) == 1, kinds
    to_program = clock(tr.kernels, marks, spans)    # or NoClock, and why
    starts = defaultdict(list)
    for s, _, key in tr.kernels:
        starts[key].append(s)
    # paired from the stretch's end, as the clock pairs them
    kernel_of = {}
    for key in starts:
        ts = [t for k, t in marks if k == key]
        kernel_of.update(zip(reversed(ts), reversed(starts[key])))
    nexts = [f[2] for f in forwards[1:]] + [float("inf")]
    for f, frame in enumerate(per_frame):
        for key, t in frame:
            if t in kernel_of:
                start = to_program(kernel_of[t])
                assert forwards[f][2] <= start < nexts[f], (f, key, start)
    assert len(kernel_of) >= len(marks) - len(per_frame[0])


@pytest.mark.cuda
def test_the_clock_recovers_planted_gaps_on_the_card():
    """A known answer for the clock and the idle readers
    (``bench_port/spans.py``): 24 frames under a device-only profiler, each
    a ``forward`` span that launches the port's LayerNorm kernel (B5,
    marked), sleeps PLANT_S, launches an aten kernel (unmarked), sleeps
    PLANT_S and launches B5 again; the caller then sleeps PLANT_S.  In the
    second half of the stretch (a trace can miss its first launches, and
    its device times settle over its first frames):

    * the device's time from one B5 to the next is the host's from mark to
      mark, within PLANT_US in the median over the frames;
    * the unmarked kernel, placed by the B5 launches around it, starts on
      the program's clock, in the median over the frames, no earlier than
      PLANT_US before the host asked for it and no later than the host's
      dispatch and PLANT_US after it;

    and the readers count each planted gap where it was planted: the two
    inside each frame under ``forward``, those between frames under the
    caller."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the chip")
    from bench_port import spans as readers
    from bench_port.trace import traced
    from dhd_tpu_torch.ops.layer_norm import fused_layer_norm_cuda

    dev = torch.device("cuda")
    frames = 24
    x = torch.randn(4096, 256, device=dev, dtype=torch.bfloat16)
    w = torch.ones(256, device=dev)
    b = torch.zeros(256, device=dev)
    y = torch.ones(1024, device=dev)
    fused_layer_norm_cuda(x, w, b, 1e-5)
    y.mul_(1.0)
    torch.cuda.synchronize()
    asked = []                      # host us just before each aten launch

    def run():
        for _ in range(frames):
            with profiling.span("forward"):
                fused_layer_norm_cuda(x, w, b, 1e-5)
                time.sleep(PLANT_S)
                asked.append(time.time_ns() / 1e3)
                y.mul_(1.0)
                time.sleep(PLANT_S)
                fused_layer_norm_cuda(x, w, b, 1e-5)
            time.sleep(PLANT_S)
    profiling.reset()
    tr = traced(run, frames)
    spans = [(n, d, t0 / 1e3, t1 / 1e3) for n, d, t0, t1 in profiling.spans()]
    marks = [(k, t / 1e3) for k, t in profiling.launch_marks()]
    to_program = readers.clock(tr.kernels, marks, spans)
    # marks and kernels pair from the stretch's end, as the clock pairs them
    ln = [k for k in tr.kernels if k[2] == "layer_norm_kernel"]
    aten = [k for k in tr.kernels if k[2] != "layer_norm_kernel"]
    later = range(frames // 2, frames)
    assert len(marks) == 2 * frames and len(ln) >= frames \
        and len(aten) >= len(later), (len(marks), len(ln), len(aten))
    gone = [(ln[-k + 1][0] - ln[-k][0]) - (marks[-k + 1][1] - marks[-k][1])
            for k in (2 * (frames - f) for f in later)]
    assert abs(statistics.median(gone)) <= PLANT_US, gone
    late = [to_program(aten[-k][0]) - asked[-k]
            for k in (frames - f for f in later)]
    assert -PLANT_US <= statistics.median(late) <= DISPATCH_US + PLANT_US, \
        late
    # the readers, over the same stretch: a gap before the first B5 of a
    # frame is the caller's, the others the frame's
    first = set(ln[-2::-2])
    ks = tr.kernels
    inside = sum(b_[0] - a[1] for a, b_ in zip(ks, ks[1:]) if b_ not in first)
    between = sum(b_[0] - a[1] for a, b_ in zip(ks, ks[1:]) if b_ in first)
    ctx = types.SimpleNamespace(
        trace=tr, items=frames, detail=types.SimpleNamespace(items=0),
        loop=types.SimpleNamespace(device=dev))
    assert readers.idle_ms(ctx, ("forward",)) == pytest.approx(
        inside / 1e3 / frames, rel=1e-9)
    assert readers.idle_ms(ctx, outside=True) == pytest.approx(
        between / 1e3 / frames, rel=1e-9)
