"""The port's benchmark CLI (dhd_tpu_torch.cli.benchmark) run in-process
on the CPU with ``--device cpu``, on the tiny presets: every mode prints
the JAX CLI's lines with finite times (``train`` its losses too;
``exported`` is tests/test_torch_export.py's); without ``--device`` and
without a GPU it raises."""
import dataclasses
import math
import re

import pytest
import torch

from dhd_tpu_torch.cli.benchmark import main
from dhd_tpu_torch.config import get_config
from dhd_tpu_torch.models.dhd import (build_image_backbone,
                                      stereo_feat_channels)

MS = re.compile(r"([-\w.]+|nan|inf) ms")


def _run(capsys, *argv):
    assert main([*argv, "--device", "cpu", "--iters", "1"]) == 0
    return capsys.readouterr().out


def _lines(out, *labels):
    """The line starting with each label, and its times, all finite."""
    lines = out.splitlines()
    for label in labels:
        found = [ln for ln in lines if ln.startswith(label)]
        assert found, f"no line {label!r} in:\n{out}"
        times = [float(t) for t in MS.findall(found[0])]
        assert times and all(math.isfinite(t) and t >= 0 for t in times), \
            found[0]


@pytest.mark.parametrize("argv,labels", [
    (("--preset", "dhd_tiny", "--what", "full"),
     ("dhd_tiny end-to-end:",)),
    (("--preset", "dhd_tiny", "--what", "stages", "--fp32"),
     ("img_encoder:", "view_transform:", "bev_encoder:",
      "voxel_encoder0 (unet", "voxel_encoder1 (unet",
      "voxel_encoder2 (unet")),
    (("--preset", "dhd_tiny", "--what", "pool", "--fp32"),
     ("mghs_pool plain index_add_:", "mghs_pool cuda (plan built in the "
      "call) [plain, cpu]:", "mghs_pool cuda + plan (serving) [plain, "
      "cpu]:", "raw index_add_ segment_sum:", "raw cuda segment_sum (sorts "
      "inside) [plain, cpu]:", "raw cuda segment_sum split [plain, cpu]:")),
    (("--preset", "dhd_micro_stereo", "--what", "stream", "--fp32"),
     ("dhd_micro_stereo streaming inference:",)),
    (("--preset", "dhd_micro_stereo", "--what", "cv", "--fp32"),
     ("plan build:", "plan build from cv_static", "kernel+layout (prebuilt "
      "plan) [plain, cpu]:", "full stereo_cost_volume (plan+kernel+softmax)"
      " [plain, cpu]:", "full stereo_cost_volume with cv_static")),
], ids=["full", "stages", "pool", "stream", "cv"])
def test_mode_prints_finite_times(capsys, argv, labels):
    _lines(_run(capsys, *argv), *labels)


def test_stream_ships_the_rig_static_plans(capsys):
    out = _run(capsys, "--preset", "dhd_micro_stereo", "--what", "stream",
               "--fp32")
    assert "stream frames ship pool_plan and cv_static" in out


@pytest.mark.parametrize("preset,narrow", [
    ("dhd_micro_stereo", {}), ("dhd_m", {}),
    ("dhd_l", {"swin_embed_dims": 16, "swin_depths": (1, 1, 1, 1)})])
def test_cv_feature_width_is_the_stereo_backbones(preset, narrow):
    """``--what cv`` sizes its stereo features from the config: the first
    of the stereo backbone's out_channels (DHD-L's Swin at a narrow
    width)."""
    cfg = dataclasses.replace(get_config(preset), **narrow)
    assert cfg.stereo
    assert (stereo_feat_channels(cfg)
            == build_image_backbone(cfg).out_channels[0])


def test_flops_counts_the_plain_forward(capsys):
    out = _run(capsys, "--preset", "dhd_tiny", "--what", "flops", "--fp32")
    flops = re.search(r"forward flops: ([\d.]+) G", out)
    params = re.search(r"params: ([\d.]+) M", out)
    assert flops and float(flops.group(1)) > 0
    assert params and float(params.group(1)) > 0
    assert "bytes accessed: not counted" in out


def test_profile_prints_ranges_and_top_ops(capsys):
    """On the CPU the trace has no device: the times are the host's and
    the lines say so."""
    out = _run(capsys, "--preset", "dhd_tiny", "--what", "full", "--fp32",
               "--profile", "--profile-ops", "5")
    _lines(out, "[profile] module step:", "[profile] host time (step):")
    assert "[profile] top ops by host time:" in out
    assert "device" not in out
    assert len([ln for ln in out.splitlines()
                if re.match(r"\s+[\d.]+ ms\s+x\d+", ln)]) == 5


def test_train_prints_ms_per_step_and_finite_losses(capsys):
    """``--what train``: the whole train step, by default in bf16 mixed
    precision as the JAX CLI trains; ms/step, samples/s and a busy time,
    all finite, and finite losses; on the CPU the memory is not measured
    and the times are the host's."""
    out = _run(capsys, "--preset", "dhd_tiny", "--what", "train",
               "--profile-ops", "3")
    _lines(out, "dhd_tiny train step:", "host busy (one traced step):")
    assert "(bf16 mixed precision, B=1" in out
    assert "peak memory: not measured" in out
    losses = dict(kv.split("=") for kv in re.search(
        r"^losses: (.*)$", out, re.M).group(1).split())
    assert {"loss_total", "loss_height", "loss_occ", "grad_norm"} <= \
        set(losses)
    assert all(math.isfinite(float(v)) for v in losses.values())
    assert "device busy" not in out


def test_train_fp32_flag_gives_the_fp32_step(capsys, monkeypatch):
    """``--what train --fp32`` trains with the forward in fp32 (the traced
    step, which the test above reads, left out)."""
    import dhd_tpu_torch.profiling as P
    monkeypatch.setattr(P, "trace_device", lambda run, dev, collapse: {
        "ops": {}, "op_events": {}, "clock": "host"})
    out = _run(capsys, "--preset", "dhd_tiny", "--what", "train", "--fp32",
               "--profile-ops", "1")
    _lines(out, "dhd_tiny train step:")
    assert "(fp32, B=1" in out and "bf16" not in out


def test_train_pool_plan_is_single_frame_only():
    with pytest.raises(SystemExit, match="single-frame"):
        main(["--preset", "dhd_micro_stereo", "--what", "train",
              "--pool-plan", "--device", "cpu", "--iters", "1"])


def test_raises_without_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--preset", "dhd_tiny", "--what", "pool", "--iters", "1"])
