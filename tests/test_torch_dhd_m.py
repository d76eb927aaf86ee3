"""DHD-M on the CPU at a tiny size: a DHD-M-shaped stand-in streamed two
frames against the benchmark's frozen plain reference (``bench_port/
reference/``) with the benchmark's seeded weights, in fp32; the three spans
that split the served frame's ``head`` in DHD-S-, DHD-M- and DHD-L-shaped
models; and DHD-M's configuration file against the port's preset, field
for field (the full model takes ~12 s to build here, so it is not built).
"""
import dataclasses
import json
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_port import inputs
from bench_port.loops import port_config
from bench_port.reference import models as ref_models
from bench_port.reference.config import config_from_dict
from bench_port.weights import make_weights
from chip_smoke import tiny_dhd_m
from dhd_tpu_torch import profiling
from dhd_tpu_torch.config import ModelConfig, get_config
from dhd_tpu_torch.models import (build_batch_pool_plan, build_model,
                                  build_stream_cv_static,
                                  build_stream_pool_plan)
from torch_cases import tiny_dhd_l

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 1e-5          # of the reference's peak: both run the same fp32 ops
HEAD_PARTS = [("bev_encoder", 2), ("voxel_encoders", 2), ("fuse", 2)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: under the test lane's parallel workers the tiny
    models' small ops otherwise stall on the other workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_file(cfg: ModelConfig) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def _close(a, b):
    a, b = a.float(), b.float()
    assert float((a - b).abs().max()) <= TOL * float(b.abs().max())


def _stream(cfg, n_frames=2, seed=5):
    """The stream's frames from the benchmark's rig, poses and images."""
    rig = inputs.rig(cfg, seed)
    geom = inputs.on_device({k: v for k, v in rig.items()
                             if k != "ego2global"}, CPU)
    poses = inputs.ego_poses(rig, n_frames, 0.5, CPU)
    pool = inputs.image_pool(cfg, n_frames, seed + 1, CPU, torch.float32)
    return [dict(geom, imgs=pool[i], ego2global=poses[i])
            for i in range(n_frames)]


def test_two_frame_stream_against_the_reference():
    cfg = tiny_dhd_m()
    ref_cfg = config_from_dict(_as_file(cfg))
    port = build_model(cfg, device=CPU)
    ref = ref_models.build_model(ref_cfg, device=CPU)
    weights = make_weights(ref_cfg, 11, CPU, gain=2.0)
    port.load_state_dict(weights)
    ref.load_state_dict(weights)
    assert type(port.img_bev_encoder_backbone).__name__ == "UNet"
    c_port, c_ref = {}, {}
    with torch.no_grad():
        for frame in _stream(ref_cfg):
            o_port, c_port = port(frame, cache=c_port)
            o_ref, c_ref = ref(frame, cache=c_ref)
            _close(o_port["occ_logits"], o_ref["occ_logits"])
    _close(c_port["vox"], c_ref["vox"])


def _served_frame(cfg):
    """``step()`` serves one frame of ``cfg`` with the rig's cached plans;
    a stream's first frame (no history) is served already."""
    model = build_model(cfg, device=CPU,
                        generator=torch.Generator().manual_seed(0))
    frame = _stream(cfg, 1)[0]
    if not cfg.temporal:
        frame = dict(frame, sensor2keyego=frame["sensor2ego"])
        frame["pool_plan"] = build_batch_pool_plan(cfg, frame, device=CPU)
        return lambda: model(frame)
    frame["pool_plan"] = build_stream_pool_plan(cfg, frame, device=CPU)
    frame["cv_static"] = build_stream_cv_static(cfg, frame, device=CPU)
    state = {"cache": {}}

    def step():
        out, state["cache"] = model(frame, cache=state["cache"])
        return out
    step()
    return step


@pytest.mark.parametrize("make", [lambda: get_config("dhd_tiny"), tiny_dhd_m,
                                  lambda: tiny_dhd_l(get_config)],
                         ids=["dhd_s_shaped", "dhd_m_shaped", "dhd_l_shaped"])
def test_head_splits_into_three_spans(make):
    """Under a profiler the served frame's ``head`` holds ``bev_encoder``,
    ``voxel_encoders`` and ``fuse`` at depth 2, in that order, each inside
    it, whatever the BEV encoder."""
    step = _served_frame(make())
    profiling.reset()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        step()
    spans = profiling.spans()
    names = [(s[0], s[1]) for s in spans]
    at = names.index(("head", 1))
    assert names[at + 1:at + 4] == HEAD_PARTS
    _, _, h0, h1 = spans[at]
    for _, _, t0, t1 in spans[at + 1:at + 4]:
        assert h0 <= t0 < t1 <= h1
    profiling.reset()


def test_the_configuration_file_is_the_ports_preset():
    """``bench_port/configs/dhd_m.json`` holds every field of the port's
    ``dhd_m`` preset, and the benchmark builds exactly that preset from
    it; nothing is cut."""
    path = ROOT / "bench_port" / "configs" / "dhd_m.json"
    file = json.loads(path.read_text())
    preset = get_config("dhd_m")
    assert (file["name"], file["preset"], file["precision"],
            file["reduced"]) == ("dhd_m", "dhd_m", "bfloat16", [])
    assert file["source"].endswith("projects/configs/DHD/DHD-M.py")
    assert file["model"] == _as_file(preset)
    built = port_config(file)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(built, f.name) == getattr(preset, f.name), f.name
    # the reference reads the same file into the same fields
    assert _as_file(config_from_dict(file["model"])) == file["model"]
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == "dhd_m")
    assert (entry["source"], entry["file"], entry["reduced"]) == (
        file["source"], "bench_port/configs/dhd_m.json", [])
