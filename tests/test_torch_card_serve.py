"""The port's models, CLIs and programs on the card, beyond the kernels
alone: the kernels one served frame of DHD-S, DHD-M and DHD-L launches;
the small presets in fp32 against the CPU; the benchmark CLI's modes;
``cli/test`` on DHD-S's synthetic batches and on a nuScenes-format
fixture; DHD-L's eval forward; RayIoU and the density render against the
CPU; exported, baked and int8 programs loaded fresh.  Every test needs a CUDA
device and skips without one.  The served frames' outputs are held
against the plain reference by the benchmark (``bench_port/``); replayed
frames against eager ones by tests/test_torch_graphs.py.  No JAX here: on
the GPU machine run ``python -m pytest --noconftest
tests/test_torch_card_serve.py -q``."""
import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from chip_variants import bf16_ulp_diff, stream_frames
from dhd_tpu_torch import profiling
from dhd_tpu_torch.config import get_config
from dhd_tpu_torch.data import synthetic_batch
from dhd_tpu_torch.models import (build_batch_pool_plan, build_model,
                                  build_stream_cv_static,
                                  build_stream_pool_plan)
from dhd_tpu_torch.ops.unet_epilogue import COUNTER as UNET_COUNTER
from torch_cases import (full_fp32, launches, occupancy_scene,
                         swin_launches, tiny_dhd_l, write_nuscenes_fixture)

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16
ARGMAX_MIN = 0.999          # voxels with the reference path's class
TINY_REL_TOL = 2e-4         # fp32 on the card vs fp32 on the CPU, of peak
UNET_LAUNCHES = 22          # epilogue launches a base-64 UNet
RAYIOU_TOL = 1e-4           # each RayIoU key, card against the CPU
RAY_MOVED_MAX = 1e-4        # share of rays that may stop at another voxel
DVR_TOL = 1e-4              # dvr.render card vs CPU, of the peak
INT8_FLIP_MAX = 0.02        # voxels whose class int8 may flip (JAX's own
#                             bound, tests/test_quant.py)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel_to_peak(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(1e-3, float(b.abs().max()))


def frame_launches(cfg, planned: bool) -> dict:
    """The kernels one served frame of ``cfg`` launches, by wrapper: B1
    once, and its plan kernels once where the frame plans in the call; B3
    once in a stereo stream; B4 and B5 through the Swin of the new frame
    (``torch_cases.swin_launches``); the UNet epilogues 22 a UNet, in the
    three slab encoders and DHD-M's BEV encoder."""
    out = {"mghs_pool_cuda": 1,
           UNET_COUNTER: UNET_LAUNCHES * (3 + (cfg.bev_encoder == "unet"))}
    if planned:
        out["pool_plan_cuda"] = 1
    if cfg.stereo:
        out["stereo_cost_volume_cuda"] = 1
    if cfg.backbone == "swin_base":
        out.update(swin_launches(cfg, 1))
    return out


@pytest.mark.parametrize("preset", ["dhd_s", "dhd_m", "dhd_l"])
def test_a_served_frame_launches_each_kernel(cuda, preset):
    """At full width in bf16 with seeded weights: one frame planned in the
    call, then the first frame with the rig's cached plans (both eager),
    each launching :func:`frame_launches`; a stream's frames after its
    bootstrap frame.  Finite logits of the grid's shape."""
    cfg = get_config(preset)
    model = build_model(cfg, dtype=BF16, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    if cfg.temporal:
        frames = stream_frames(cfg, 3)
        plans = {"pool_plan": build_stream_pool_plan(cfg, frames[0],
                                                     device=cuda),
                 "cv_static": build_stream_cv_static(cfg, frames[0],
                                                     device=cuda)}
        _, cache = model(frames[0], cache={})

        def serve(frame):
            return model(frame, cache=cache)[0]
    else:
        rig = synthetic_batch(cfg, batch_size=1, seed=0, with_gt=False)
        frames = [dict(rig, imgs=np.random.default_rng(100 + k).normal(
            0, 1, rig["imgs"].shape).astype(np.float32)) for k in range(3)]
        plans = {"pool_plan": build_batch_pool_plan(cfg, rig, device=cuda)}
        serve = model
    want = (1, cfg.vt.x.size, cfg.vt.y.size, cfg.head_Dz, cfg.num_classes)
    for frame, planned in ((frames[1], True),
                           (dict(frames[2], **plans), False)):
        profiling.reset()
        occ = serve(frame)["occ_logits"]
        torch.cuda.synchronize()
        assert profiling.counters().get("graph_replays", 0) == 0
        assert launches() == frame_launches(cfg, planned)
        assert tuple(occ.shape) == want
        assert bool(torch.isfinite(occ).all())


@pytest.mark.parametrize("name", ["dhd_tiny", "dhd_micro_stereo",
                                  "tiny_dhd_l"])
def test_small_models_on_the_card_follow_the_cpu(cuda, name):
    """The small presets in fp32 (TF32 off), the card's kernel path
    against the same weights' plain path on the CPU: logits, depth and
    height within 2e-4 of their peak; a temporal one over two streamed
    frames."""
    cfg = tiny_dhd_l(get_config) if name == "tiny_dhd_l" \
        else get_config(name)
    gpu = build_model(cfg, device=cuda,
                      generator=torch.Generator().manual_seed(3))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    errs = {}
    with full_fp32():
        if cfg.temporal:
            cache_g, cache_c = {}, {}
            for step, frame in enumerate(stream_frames(cfg, 2, seed=4)):
                out_g, cache_g = gpu(frame, cache=cache_g)
                out_c, cache_c = cpu(frame, cache=cache_c)
                for k in ("occ_logits", "depth", "height"):
                    errs[f"{k}{step}"] = _rel_to_peak(out_g[k].cpu(),
                                                      out_c[k])
        else:
            batch = synthetic_batch(cfg, batch_size=2, seed=4,
                                    with_gt=False)
            out_g, out_c = gpu(batch), cpu(batch)
            errs = {k: _rel_to_peak(out_g[k].cpu(), out_c[k])
                    for k in ("occ_logits", "depth", "height")}
    assert all(e < TINY_REL_TOL for e in errs.values()), errs


def _export(argv):
    from dhd_tpu_torch.cli.export import main as export
    assert export(argv) == 0


@pytest.fixture(scope="module")
def dhd_s_program(cuda, tmp_path_factory):
    """DHD-S exported in bf16, the program and its weights apart."""
    path = str(tmp_path_factory.mktemp("programs") / "dhd_s_split.pt2")
    _export(["--preset", "dhd_s", "--out", path, "--bf16"])
    return path


# (mode, preset, arguments, the kernels it must launch): pool, stages and
# full plan in the call, with B1's plan kernels
CLI_RUNS = [
    ("pool", "dhd_s", ["--iters", "10"],
     ("sorted_segment_sum", "mghs_pool_cuda", "pool_plan_cuda")),
    ("pool", "dhd_l", ["--iters", "10"],
     ("sorted_segment_sum", "mghs_pool_cuda", "pool_plan_cuda")),
    ("stream", "dhd_m", ["--iters", "5"],
     ("mghs_pool_cuda", "stereo_cost_volume_cuda")),
    ("cv", "dhd_l", ["--iters", "5"], ("stereo_cost_volume_cuda",)),
    ("stages", "dhd_s", ["--iters", "5"],
     ("mghs_pool_cuda", "pool_plan_cuda")),
    ("flops", "dhd_s", [], ()),
    ("full", "dhd_s", ["--iters", "5", "--profile", "--profile-ops", "8"],
     ("mghs_pool_cuda", "pool_plan_cuda")),
    ("train", "dhd_s", ["--iters", "3", "--batch-size", "4",
                        "--profile-ops", "8"],
     ("mghs_pool_cuda", "pool_plan_cuda")),
    ("train", "dhd_s", ["--iters", "3", "--batch-size", "4", "--pool-plan",
                        "--profile-ops", "8"],
     ("mghs_pool_cuda", "pool_plan_cuda")),
    ("exported", None, ["--iters", "10"], ()),
]


@pytest.mark.parametrize("what,preset,extra,must", CLI_RUNS,
                         ids=[f"{w}-{p or 'dhd_s'}" + ("-pool_plan" if
                                                       "--pool-plan" in e
                                                       else "")
                              for w, p, e, _ in CLI_RUNS])
def test_the_benchmark_cli_on_the_card(cuda, capsys, dhd_s_program, what,
                                       preset, extra, must):
    """Each mode returns 0, prints finite times and launches the kernels
    of its path; ``stream`` ships the rig's plans; ``train`` prints finite
    losses, the traced step and the peak memory; ``exported`` runs the
    DHD-S program, B1 and its plan once an iteration and once warming
    up."""
    from dhd_tpu_torch.cli.benchmark import main as benchmark

    argv = (["--what", what, "--artifact", dhd_s_program] if preset is None
            else ["--preset", preset, "--what", what])
    capsys.readouterr()
    profiling.reset()
    assert benchmark(argv + extra) == 0
    text = capsys.readouterr().out
    counted = launches()
    torch.cuda.empty_cache()
    if what == "flops":
        flops = re.search(r"forward flops: ([\d.]+) G", text)
        assert flops is not None and float(flops.group(1)) > 0, text
    else:
        times = [float(t) for t in re.findall(r"(\S+) ms\b", text)]
        assert times and all(math.isfinite(t) and t >= 0 for t in times), \
            text
    assert all(counted.get(k, 0) > 0 for k in must), counted
    if what == "stream":
        assert "ship pool_plan and cv_static" in text
    if what == "train":
        losses = re.search(r"^losses: (.*)$", text, re.M)
        assert losses is not None and all(
            math.isfinite(float(kv.split("=")[1]))
            for kv in losses.group(1).split()), text
        assert "device busy" in text and "peak memory: " in text
        assert "--pool-plan" not in extra \
            or "ships a precomputed pool plan" in text
    if what == "exported":
        assert re.search(r"exported artifact .*?: [\d.]+ ms/iter", text)
        assert counted["mghs_pool_cuda"] == counted["pool_plan_cuda"] == 11


def eval_launches(cfg) -> dict:
    """The kernels one sample's eval forward launches (the F-frame forward
    of a temporal preset, plans built in the call): B1 and its plan
    kernels once a frame through the whole model, B3 as often in a stereo
    model; B4 and B5 through the Swin of those frames and the extra stereo
    frame's stage 0."""
    full = cfg.num_frames - (1 if cfg.stereo else 0)
    out = {"mghs_pool_cuda": full, "pool_plan_cuda": full}
    if cfg.stereo:
        out["stereo_cost_volume_cuda"] = full
    if cfg.backbone == "swin_base":
        out.update(swin_launches(cfg, full, int(cfg.stereo)))
    return out


def _plain_agreement(cfg, model, batches, preds):
    """Share of voxels where the plain path (every kernel's plain version,
    the same weights) predicts the class in ``preds``."""
    plain = build_model(dataclasses.replace(
        cfg, pool_method="xla", cv_method="xla", attn_method="xla",
        ln_method="xla"), dtype=model.dtype, device=model.device)
    plain.load_state_dict(model.state_dict())
    with torch.inference_mode():
        return float(np.mean([
            (plain(b)["occ_logits"].argmax(-1) == p).float().mean().item()
            for b, p in zip(batches, preds)]))


def test_dhd_l_eval_forward_on_the_card(cuda):
    """DHD-L's eval forward at full width, bf16, B=1: the history and
    extra stereo frames, aligned after the view transformation as
    ``cli/test`` sets it; each kernel's launches a sample exact; at least
    99.9% of voxels with the plain path's class."""
    cfg = dataclasses.replace(get_config("dhd_l"),
                              align_after_view_transformation=True)
    model = build_model(cfg, dtype=BF16, device=cuda)
    batches = [synthetic_batch(cfg, batch_size=1, seed=i) for i in range(2)]
    per = eval_launches(cfg)
    profiling.reset()
    with torch.inference_mode():
        preds = [model(b)["occ_logits"].argmax(-1) for b in batches]
    torch.cuda.synchronize()
    assert launches(per) == {k: 2 * v for k, v in per.items()}
    assert _plain_agreement(cfg, model, batches, preds) >= ARGMAX_MIN


def test_eval_cli_ann_file_on_the_card(cuda, capsys, tmp_path):
    """``cli/test --ann-file --eval ray-iou`` on two samples in nuScenes'
    format with six 1600x900 JPEG cameras (PIL decodes, resizes and crops
    each to 256x704): both samples evaluated in order, RayIoU and mIoU
    printed, B1 and its plan kernels once a sample."""
    from dhd_tpu_torch.cli.test import main as evaluate

    pkl = write_nuscenes_fixture(str(tmp_path), 2)
    per = eval_launches(get_config("dhd_s"))
    capsys.readouterr()
    profiling.reset()
    assert evaluate(["--preset", "dhd_s", "--ann-file", pkl,
                     "--eval", "ray-iou"]) == 0
    text = capsys.readouterr().out
    assert launches(per) == {k: 2 * v for k, v in per.items()}
    for line in ("evaluated 2 samples", "rayiou-samples: tok0 tok1",
                 "RayIoU@4: ", "===> mIoU: "):
        assert line in text, text


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
def test_eval_cli_dhd_s_on_the_card(cuda, capsys, monkeypatch, dtype):
    """``cli/test --preset dhd_s --synthetic [--bf16]`` at full width, B=1,
    2 batches: B1 and its plan kernels once a batch; the card's confusion
    matrix equal to a float64 numpy count of the predicted grids; at least
    99.9% of voxels with the plain path's class (the same seeded weights)."""
    from dhd_tpu_torch.cli.test import main as evaluate
    from dhd_tpu_torch.eval import MIoUMetric

    seen = {"metric": None, "preds": []}
    add = MIoUMetric.add_batch

    def record(self, pred, gt, mask):
        seen["metric"] = self
        seen["preds"].extend(pred)
        return add(self, pred, gt, mask)

    monkeypatch.setattr(MIoUMetric, "add_batch", record)
    cfg = get_config("dhd_s")
    per = eval_launches(cfg)
    capsys.readouterr()
    profiling.reset()
    assert evaluate(["--preset", "dhd_s", "--synthetic",
                     *(["--bf16"] if dtype == BF16 else [])]) == 0
    text = capsys.readouterr().out
    assert launches(per) == {k: 2 * v for k, v in per.items()}
    assert "evaluated 2 samples" in text and "===> mIoU: " in text, text

    preds = seen["preds"]
    batches = [synthetic_batch(cfg, batch_size=1, seed=i) for i in range(2)]
    cm = np.zeros((cfg.num_classes,) * 2, np.float64)
    for pred, b in zip(preds, batches):
        m = b["mask_camera"][0] != 0
        np.add.at(cm, (b["voxel_semantics"][0][m].astype(np.int64),
                       pred.cpu().numpy()[m].astype(np.int64)), 1.0)
    assert len(preds) == 2 and np.array_equal(seen["metric"].cm, cm)
    model = build_model(cfg, dtype=dtype, device=cuda)
    assert _plain_agreement(cfg, model, batches, preds) >= ARGMAX_MIN


def _scene_infos(n: int = 12):
    """One synthetic nuScenes scene: the ego drives 4 m a sample along a
    gentle curve, nuScenes' lidar mount (0.94 m ahead, 1.84 m up)."""
    return [{"token": f"tok{i}", "scene_token": "scene0",
             "ego2global_rotation": [math.cos(0.01 * i), 0.0, 0.0,
                                     math.sin(0.01 * i)],
             "ego2global_translation": [411.3 + 4.0 * i,
                                        1180.6 + 0.04 * i * i, 0.0],
             "lidar2ego_rotation": [0.7071, 0.0, 0.0, 0.7071],
             "lidar2ego_translation": [0.94, 0.0, 1.84]} for i in range(n)]


def test_rayiou_on_the_card_follows_the_cpu(cuda):
    """RayIoU at Occ3D's 200x200x16 over the lidar fan from the 8 origins
    ``scene_origins`` takes of a scene, the prediction 5% of the occupied
    voxels of another class and 2% of the free ones filled: the card's
    RayIoU keys within 1e-4 of the CPU's, at most 0.01% of the rays at
    another first hit; ``dvr.render`` of the scene's density along the
    first origin's fan to 30 m, at most 0.01% of its distances and
    gradients past 1e-4 of their peak, and more than half the rays valid."""
    from dhd_tpu_torch.eval.rayiou import (FREE_ID, PC_RANGE, VOXEL_SIZE,
                                           generate_lidar_rays, march,
                                           ray_endpoints,
                                           rayiou_from_outputs,
                                           scene_origins)
    from dhd_tpu_torch.ops.dvr import render

    origins = scene_origins(_scene_infos(), 6)
    assert len(origins) >= 8
    gt = occupancy_scene(0)
    rng = np.random.default_rng(1)
    pred = gt.copy()
    occ = gt != FREE_ID
    flip = occ & (rng.random(gt.shape) < 0.05)
    pred[flip] = rng.integers(0, 17, int(flip.sum()))
    fill = ~occ & (rng.random(gt.shape) < 0.02)
    pred[fill] = rng.integers(0, 17, int(fill.sum()))
    sides = {"card": cuda, "cpu": torch.device("cpu")}
    res = {side: rayiou_from_outputs([pred], [gt], [origins], device=d)
           for side, d in sides.items()}
    for k in ("RayIoU", "RayIoU@1", "RayIoU@2", "RayIoU@4"):
        assert abs(res["card"][k] - res["cpu"][k]) <= RAYIOU_TOL, k

    rays = generate_lidar_rays()
    o_vox, ends = ray_endpoints(rays, origins, PC_RANGE, VOXEL_SIZE)
    r, shape = len(ends), gt.shape
    hits = {}
    for side, d in sides.items():
        grids = torch.as_tensor(np.stack([pred, gt]) != FREE_ID, device=d)
        hits[side] = [t.cpu().numpy() for t in march(
            grids.reshape(-1), shape,
            torch.from_numpy(np.tile(o_vox, (2, 1))).to(d),
            torch.from_numpy(np.tile(ends, (2, 1))).to(d),
            torch.arange(2, device=d).repeat_interleave(r)
            * int(np.prod(shape)))]
    assert len(hits["cpu"][1]) == 2 * r
    moved = ~(hits["card"][1] == hits["cpu"][1]).all(axis=1)
    assert moved.mean() <= RAY_MOVED_MAX

    sigma = np.where(occ.transpose(2, 1, 0), 2.0,
                     0.02).astype(np.float32)[None, None]
    pts = ((rays * 30.0 + origins[0] - np.asarray(PC_RANGE[:3], np.float32))
           / VOXEL_SIZE).astype(np.float32)[None]
    case = [torch.from_numpy(a) for a in (sigma, o_vox[0][None, None], pts,
                                          np.zeros(pts.shape[:2],
                                                   np.float32))]
    want = render(*case)
    got = render(*(t.to(cuda) for t in case))
    for k in (0, 2):                     # pred_dist, grad_sigma
        e = (got[k].cpu() - want[k]).abs() / max(1e-6,
                                                 float(want[k].abs().max()))
        assert float((e > DVR_TOL).float().mean()) <= RAY_MOVED_MAX, k
    assert float((want[0] >= 0).float().mean()) > 0.5


def test_a_bf16_batchnorm_on_the_card_is_the_fp32_formula(cuda):
    """A bf16 model's eval BatchNorm keeps fp32 statistics and affine; on
    the card its bf16 output lies within one bf16 ulp of the fp32
    formula's, at DHD-S's 6x64x176 image features."""
    from dhd_tpu_torch.nn.layers import BatchNorm2d

    g = torch.Generator(device=cuda).manual_seed(0)
    bn = BatchNorm2d(64).eval().to(cuda).to(BF16)
    with torch.no_grad():
        for t, lo, hi in ((bn.running_mean, -2, 2), (bn.running_var, 0.1, 1),
                          (bn.weight, 0.5, 2), (bn.bias, -1, 1)):
            t.uniform_(lo, hi, generator=g)
        x = (3 * torch.randn((6, 64, 64, 176), generator=g,
                             device=cuda)).to(BF16)
        y = bn(x)
        want = ((x.float() - bn.running_mean[:, None, None])
                * (torch.rsqrt(bn.running_var + bn.eps)
                   * bn.weight)[:, None, None]
                + bn.bias[:, None, None]).to(BF16)
    assert bn.weight.dtype == bn.running_var.dtype == torch.float32
    assert y.dtype == BF16 and bf16_ulp_diff(y, want) <= 1


def _program_classes(fn, model, cfg, meta, dev, seeds):
    """The loaded program's and the live model's classes on new batches,
    with the launches the program made."""
    from dhd_tpu_torch.cli.export import batch_inputs

    batches = [batch_inputs(synthetic_batch(cfg, 1, seed=s, with_gt=False),
                            meta["inputs"], dev) for s in seeds]
    profiling.reset()
    with torch.no_grad():
        got = [fn(b) for b in batches]
        torch.cuda.synchronize()
        counted = launches(eval_launches(cfg))
        live = [model(b)["occ_logits"].argmax(-1).to(torch.uint8)
                for b in batches]
    return got, live, counted, batches


@pytest.mark.parametrize("preset,baked", [("dhd_s", False),
                                          ("dhd_s", True),
                                          ("dhd_l", False)],
                         ids=["dhd_s-split", "dhd_s-baked", "dhd_l-split"])
def test_exported_programs_on_the_card(cuda, tmp_path, dhd_s_program,
                                       preset, baked):
    """``cli/export`` in bf16 at full width, B=1, as the program and its
    weights apart or with ``--bake-weights``; loaded fresh, the program
    launches the kernels inside it (the ``dhd_tpu_torch::`` ops), at the
    eval forward's counts a sample, and serves at least 99.9% of the live
    model's classes (the same seeded weights) on two new batches."""
    from dhd_tpu_torch.cli.export import load_program

    path = dhd_s_program
    if baked or preset != "dhd_s":
        path = str(tmp_path / f"{preset}.pt2")
        _export(["--preset", preset, "--out", path, "--bf16",
                 *(["--bake-weights"] if baked else [])])
    cfg = get_config(preset)
    fn, meta = load_program(path)
    model = build_model(cfg, dtype=BF16, device=cuda)
    got, live, counted, _ = _program_classes(fn, model, cfg, meta, cuda,
                                             (31, 32))
    assert counted == {k: 2 * v for k, v in eval_launches(cfg).items()}
    agree = np.mean([(g == w).float().mean().item()
                     for g, w in zip(got, live)])
    assert agree >= ARGMAX_MIN


def test_int8_program_on_the_card(cuda, tmp_path, dhd_s_program):
    """DHD-S ``cli/export --bf16 --int8`` (two synthetic calibration
    batches): loaded fresh, it launches the kernels a frame and its voxel
    argmax flips against the fp program's on under 2% of voxels over 3
    held-out seeds; one Int8Conv2d's ``_int_mm`` int32 sums at a frame's
    input equal the exact conv's."""
    from dhd_tpu_torch.cli.export import (calibration_batches, load_program,
                                          parse_args)
    from dhd_tpu_torch.nn.quant import (DEFAULT_PREFIXES, Int8Conv2d,
                                        activation_scale, calibrate_int8,
                                        int8_conv_int32,
                                        int8_conv_int32_plain,
                                        quantize_model)

    cfg = get_config("dhd_s")
    path = str(tmp_path / "dhd_s_int8.pt2")
    argv = ["--preset", "dhd_s", "--out", path, "--bf16", "--int8"]
    _export(argv)
    q_fn, meta = load_program(path)
    fp_fn, _ = load_program(dhd_s_program)
    model = build_model(cfg, dtype=BF16, device=cuda)
    q_out, _, counted, batches = _program_classes(q_fn, model, cfg, meta,
                                                  cuda, (41, 42, 43))
    assert counted == {k: 3 * v for k, v in eval_launches(cfg).items()}
    with torch.no_grad():
        fp_out = [fp_fn(b) for b in batches]
    flip = np.mean([(q != f).float().mean().item()
                    for q, f in zip(q_out, fp_out)])
    assert flip < INT8_FLIP_MAX

    calib, _ = calibration_batches(cfg, parse_args(argv), meta["inputs"],
                                   cuda)
    qmodel = quantize_model(model, calibrate_int8(model, calib),
                            DEFAULT_PREFIXES)
    conv = qmodel.get_submodule("img_backbone.layer1.0.conv2")
    assert isinstance(conv, Int8Conv2d)
    seen = []
    hook = conv.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    with torch.no_grad():
        qmodel(batches[0])
    hook.remove()
    xq = torch.clamp(torch.round(seen[0].float()
                                 / activation_scale(conv.amax)),
                     -127, 127).to(torch.int8)
    wq, _ = conv.quantized_weight()
    args = (conv.stride, conv.padding, conv.dilation)
    assert torch.equal(int8_conv_int32(xq, wq, *args),
                       int8_conv_int32_plain(xq, wq, *args))
