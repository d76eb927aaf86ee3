#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dhd_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. the card's name and power limit; build the CUDA kernels from
   ``dhd_tpu_torch/csrc`` (one nvcc per source, all started together);
2. kernel vs plain: ``mghs_pool_cuda`` (B1) against its plain PyTorch
   version at DHD-S shapes in bf16 (fp32 sums), every element within one
   bf16 ulp, two calls bit-identical; times by CUDA events, median of 30
   launches each; the points per non-empty pillar (mean, p99, max, the
   pillars over 256), the device memory one call takes, and B1 with the
   plan built in the call (sort, plan, pool: device, idle-card and host
   time); then B1's plan kernels (``pool_plan_cuda``: the sorted points'
   tables and the first pass's schedule, which every plan built on the
   card runs) against their plain version: equal tables and lists, both
   timed, and the scratch slots the split pillars use against the bound
   a plan built in the call allocates;
3. serving: DHD-S at full width (B=1, 6 cameras, 256x704) in bf16 with
   seeded random weights and a cached pool plan answers 5 frames; each
   kernel must launch once per frame; one frame is repeated with the plain
   pooling forced and must agree; then 20 frames without the cached plan
   (each sorts and plans in the call, as ``cli --what full`` serves):
   their median, one frame's device busy time and host syncs, B1 and
   its plan kernels once a frame;
4. small reference: dhd_tiny in fp32 on the GPU against the same weights on
   the CPU (plain path), TF32 off;
5. kernel vs plain: ``stereo_cost_volume_cuda`` (B3) against its plain
   version at DHD-M shapes (6 cameras, 88 depth bins, 64x176, 256 bf16
   channels after a ReLU) on a rig moving 0.5 m with a small yaw, bias 5:
   softmaxed probabilities within atol 2e-5, rtol 1e-4; kernel and plain
   ms, the bound and its share of the kernel's time, the wrapper's least
   host microseconds per call, ptxas's registers, spills and shared
   memory (the B1 phases print the host microseconds too);
6. kernel vs plain: ``mghs_pool_cuda`` (B1) again at DHD-M shapes (the
   streamed frame's plan, 88 depth bins), as phase 2;
7. streaming serving: DHD-M at full width in bf16 with seeded random
   weights, a cached pool plan and the rig-static half of the stereo warp
   plan (``cv_static``), one bootstrap frame then 5 frames with the ego
   0.5 m further each; B1 and B3 must launch once per frame; one frame is
   repeated from the same cache with the plain pooling and cost volume
   forced (the plain cost volume ignores ``cv_static``) and must agree;
   then one frame read by CUDA events, by torch.profiler (with the
   cost-volume stage as a range) and by the sync debug mode (the lines
   where the host waits for the device), and the cost-volume stage's ms
   with and without ``cv_static``;
8. small reference: dhd_micro_stereo in fp32, two streaming steps on the
   GPU against the same weights on the CPU;
9. kernel vs plain: ``window_attention_cuda`` (B4) at DHD-L's four Swin-B
   stage shapes (6 images, window 12), shifted with the real mask and
   unshifted, bf16 unit-normal qkv and bias, within 4 bf16 ulps of the
   output's peak (the bar the TPU kernel held against XLA), and at one
   shape JAX sends to its v1 kernel (3 heads of 32); kernel, plain and
   ``F.scaled_dot_product_attention`` ms, kernel/SDPA, the bound and its
   share of the kernel's time, the launch-weighted ms per DHD-L frame,
   ptxas's registers and shared memory; kernel and SDPA are read twice,
   by device time and on an idle device with the host's work before the
   launch, and their host microseconds per call are printed beside;
10. kernel vs plain: ``fused_layer_norm_cuda`` (B5) at every (rows, C) of
   DHD-L's 54 LayerNorms, bf16, each element within one bf16 ulp plus
   2^-20 of the terms it is computed from; kernel, plain and
   ``F.layer_norm`` ms, kernel/library, the bound and its share, the
   launch-weighted ms per frame, ptxas's report; both readings and the
   host's microseconds per call, as in phase 9;
11. B3 and B1 again at DHD-L shapes (C=128 stereo features at 128x352; the
   streamed DHD-L frame's plan), with the same readings;
12. streaming serving: DHD-L at full width (Swin-B, 512x1408) in bf16, a
   bootstrap then 5 frames; per frame B1 and B3 once, B4 24 and B5 54
   times; one frame repeated with every plain version forced must agree
   (the backbone outputs' kernel-vs-plain drift is printed beside it);
   then the same breakdown as phase 7;
13. small reference: a tiny DHD-L-shaped config in fp32, two streaming
   steps, GPU against CPU;
14. kernel vs plain: ``sorted_segment_sum`` (B2) at the ``--what pool``
   shapes of DHD-S and DHD-L (ids uniform over 1.5 V, bf16 in and out),
   in fp32, with 10% of the points on one id, with negative ids, and at
   C = 8, 96, 160, 256 on fewer points: fp32 out within 2^-20 of the
   summed |terms|, bf16 out within one bf16 ulp plus that, empty segments
   exactly 0, the unsorted entry (``segment_sum_pooling``) bit for bit the
   sorted one; kernel, plain and ``torch.segment_reduce`` ms, the
   unsorted entry split into sort, row gather and kernel, the bound and
   its share of the kernel's time, the wrapper's least host microseconds
   per call, ptxas's registers and spills of both of B2's launches; then
   B1 at its hot pillar (DHD-S with a tenth of the frustum points, about
   17,600 in the grid, in one pillar), as phase 2, held to one bf16 ulp;
15. the benchmark CLI on the card, in-process through
   ``dhd_tpu_torch.cli.benchmark.main``: ``--what pool`` at DHD-S and
   DHD-L (B1, its plan kernels and B2 must launch), ``--what stream`` at
   DHD-M (its frames
   must ship ``cv_static``, and B1 and B3 must launch), ``--what cv`` at
   DHD-L,
   ``--what stages`` and ``--what flops`` at DHD-S, ``--what full
   --profile`` at DHD-S (stages and full plan in the call: B1 and its
   plan kernels must launch), and ``--what train`` at DHD-S, B=4, with
   and without ``--pool-plan`` (B1 and its plan kernels must launch, the
   losses be finite); every time it prints must be finite;
16. training: DHD-S at full width in fp32, B=4 (ResNet-50 with remat,
   HeightNet with DCN and ASPP, dropout from a generator), synthetic data
   with GT on the device, 2 warm-up and 3 timed train steps (forward in
   train mode, losses, backward through B1's autograd.Function with its
   plan built in the call, clip, AdamW, EMA) in PyTorch's default TF32
   mode, which the line states: ms/step, samples/s, peak memory, every
   loss and grad_norm finite, the EMA counter, B1 and its plan kernels
   exactly once a step; one step's device busy time, idle share and top
   kernels (``profiling.trace_device``) and its host syncs; then a
   checkpoint loaded into a new model (its params bit for bit the
   saved ones), whose next step gives the live run's losses bit for bit
   and AdamW's first moment within 1e-3; then B1 and its plan kernels
   against their plain versions at that step's own fp32 B=4 inputs and
   keys (B1 within 1e-5 plus 2^-20 of the terms of the plain version's
   exact sums, two calls
   bit-identical; the plan's tables equal), with their times; then the
   same training in bf16 mixed precision (the forward in bf16 over fp32
   weights), 2 + 3 steps: ms/step, memory, B1 once a step, every stored
   tensor fp32, one traced step;
17. one train step at the full learning rate of dhd_tiny (dropout off),
   dhd_micro_stereo (B3 in the forward) and the tiny DHD-L-shaped config
   (DropPath off; B4 and B5 in its history frames) on the GPU against the
   same step on the CPU, TF32 off: losses within 1e-4; gradients and
   AdamW's moments held in rel-L2 (the whole, the median and the worst
   tensor) to bars 2.5-6x the readings, beside a control (the CPU's step
   on images one part in 2^22 larger); the GPU's update within 1e-5 of a
   learning rate of AdamW's formula on its own moments;
18. training: DHD-L at full width (Swin-B at 512x1408 with block remat
   and DropPath 0.1, FPN_LSS, stereo, one history frame), B=2, in bf16
   mixed precision and in fp32 (at B=1 if B=2 does not fit), 2 + 3 steps
   each: ms/step, samples/s, peak memory; B1, its plan kernels and B3
   twice a step, B4 and B5 in the history and extra frames (26 and 59 a
   step); every loss finite, every stored tensor fp32, the BatchNorms'
   statistics stepped once per frame; one traced step's device busy
   time, idle share, top kernels, host syncs and forward stage ms; then
   one more step with every kernel's inputs recorded where the model
   calls it: B1 and its plan kernels (as phases 2 and 11, fp32 against
   the exact sums) and B3 (as phase 5) at the history and the key
   frame's inputs, B4 and B5 held against their plain versions at each
   of their 26 and 59 calls (bf16 as phases 9 and 10; fp32 B4 within
   1e-5 + 1e-5 |y|, B5 within 1e-5 plus 2^-20 of the terms), each
   shape's first call timed beside its plain version and library call.
19. evaluation, the port's ``cli/test`` in-process: DHD-S at full width
   with ``--synthetic`` (B=1, 2 batches), fp32 and ``--bf16``: B1 and its
   plan kernels once a batch, the confusion matrix counted on the card
   equal to a float64 numpy count of the grids the CLI predicted, at
   least 99.9% of voxels with the plain path's class; ms per sample of
   the eval step and the run's peak memory;
20. DHD-L's eval forward at full width (Swin-B at 512x1408), bf16, B=1,
   the history and extra stereo frames, aligned after the view
   transformation as ``cli/test`` sets it: launches per sample exact (B1,
   its plan and B3 2, B4 50, B5 113), at least 99.9% agreement with the
   plain path, ms per sample and peak memory;
21. RayIoU at 200x200x16: the 14,040-ray fan from the 8 origins
   ``scene_origins`` derives from a synthetic scene, prediction and GT in
   one march, on the card and on the CPU: the RayIoU keys within 1e-4, at
   most 0.01% of rays at another voxel, ms per sample on both; then
   ``dvr.render`` over a density grid of the scene, card vs CPU, within
   1e-4 of the peak;
22. ``cli/test --ann-file --eval ray-iou`` on a 2-sample fixture in
   nuScenes' format with six 1600x900 JPEG cameras (the data pipeline's
   PIL resize and crop), both samples once, B1 and its plan once a
   sample;
23. export: a bf16 model's BatchNorm on the card within one bf16 ulp of
   the fp32 formula (its statistics fp32); then ``cli/export``
   in-process, bf16 at full width, B=1: DHD-S as the program + weights
   split and with ``--bake-weights``, DHD-L split (three frames); each
   program loaded fresh with ``torch.export.load``: at least 99.9% of
   voxels with the live model's class on two new batches, B1 and its plan
   once a frame and DHD-L's B3, B4 and B5 at phase 20's counts a sample,
   inside the program (the ``dhd_tpu_torch::`` custom ops); ms/frame of
   the loaded program against the live model, the files' sizes, the
   export's time;
24. int8: DHD-S bf16 ``cli/export --int8`` (2 synthetic calibration
   batches): the voxel argmax over 3 held-out seeds flips against phase
   23's fp program on under 2% of voxels (printed to 4 decimals beside
   the TPU v5e's 0.4905%, a TPU number); one ``Int8Conv2d``'s
   ``_int_mm`` int32 sums equal to the exact (float64) conv's; ms/frame
   int8 against fp (loaded programs); a frame's device busy time int8
   against fp (torch.profiler) and the int8 convs' share; every backbone
   conv shape's int8 (and ``_int_mm`` alone) against bf16 cuDNN time;
25. ``cli/benchmark --what exported --artifact`` on phase 23's DHD-S
   program: a finite ms/iter, B1 and its plan launched;
26. the distributed path on one card: ``initialize_distributed`` starts a
   one-process NCCL group; two DHD-S bf16 train steps at B=4 through it
   (SyncBN, the losses' global sums, the gradients' all-reduce) against
   the same steps without a group: the first step's losses and
   BatchNorm statistics bit for bit, grad_norm and the second step within
   4x the spread of two runs without a group; ``cli/test --synthetic``
   under the group; the group destroyed at the end, also on a failure;
27. ``cli/train --ann-file`` for 2 steps at B=2 on a 4-sample fixture of
   phase 22's format with lidar sweeps (the train pipeline's augmentation
   and its lidar projection through ``native/``, built with g++ on the
   card's host): losses finite, the CLI's s/it beside the train loader's
   samples/s alone.

Phases 4, 8, 13 and 17 compare fp32 on the GPU with the CPU and turn TF32
off in cuDNN and matmul for their run; the others run in PyTorch's
defaults.

Then one JSON line listing the kernels B1-B5 and B1's plan kernels
(each shape's numbers under
``shapes``, launches per served path, per CLI run, over the timed
train steps of phases 16 and 18, per eval run of phases 19, 20 and 22,
in the loaded programs of phases 23 and 24 and in phase 26's distributed
steps under ``launches_by_path``), the
card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks: HBM bytes/s and non-tensor-core fp32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
POOL_ULP_TOL = 1            # kernel vs plain: fp32 sum order only
POOL_F32_ATOL = 1e-5        # fp32 B1 vs plain, plus 2^-20 of the terms
SERVE_REL_TOL = 2e-2        # bf16 kernel path vs bf16 plain path, of peak
SERVE_ARGMAX_MIN = 0.999
TINY_REL_TOL = 2e-4         # fp32 GPU vs fp32 CPU, of peak
CV_ATOL, CV_RTOL = 2e-5, 1e-4   # B3 vs plain probabilities: the tolerance
#                                 the TPU kernel held against XLA
CV_FLOPS_VALID = 11         # per channel: 4 bilinear FMAs, sub, abs, add
CV_FLOPS_OFF = 3            # off-image samples: sub, abs, add
BF16_FLOP_PER_S = 989e12    # dense bf16 on the tensor cores
INT8_OPS_PER_S = 1979e12    # dense int8 on the tensor cores
ATTN_ULP_TOL = 4            # B4 vs plain, bf16 ulps of the output's peak:
#                             the bar the TPU kernel held against XLA
TERM_TOL = 2.0 ** -20       # B5 (and B1 at DHD-L) vs plain, per element:
#                             one bf16 ulp of the result plus 8 fp32 ulps of
#                             the magnitudes of the terms it is computed
#                             from (fp32 sum order only; where the terms
#                             cancel the result is tiny and so are its ulps)
LN_FLOPS = 8                # per element: x, x^2 sums; sub, mul, fma, ...
ATTN_F32_TOL = 1e-5         # fp32 B4 vs plain: atol and rtol, the bar
#                             tests/test_torch_cuda.py holds the kernel to
LN_F32_ATOL = 1e-5          # fp32 B5 vs plain, plus 2^-20 of the terms
# the phase that prints each check, by preset
PHASE_OF = {"dhd_s": {"pool": 2}, "hot": {"pool": 14},
            "dhd_s_train": {"pool": 16},
            "dhd_m": {"pool": 6, "cv": 5, "stream": 7},
            "dhd_l": {"pool": 11, "cv": 11, "stream": 12}}
# B1, its plan and B3 at the inputs of one DHD-L train step, by frame
PHASE_OF.update({f"dhd_l_train_{p}_{f}": {"pool": 18, "cv": 18}
                 for p in ("bf16", "fp32") for f in ("history", "key")})
SEGSUM_IDS = 1.5            # B2's ids uniform over [0, 1.5 V), as the CLI
SLEEP_CYCLES = 2_000_000    # ~1 ms of device clock ahead of each timed call
TRAIN_WARMUP, TRAIN_STEPS = 2, 3    # DHD-S train steps, phase 16
TRAIN_STEPS_BF16 = 3                # DHD-S bf16 timed steps, phase 16
TRAIN_STEPS_DHD_L = 3               # DHD-L timed steps a precision, phase 18
TRAIN_LOSS_RTOL = 1e-4      # GPU vs CPU fp32 train-step losses, phase 17
TRAIN_RESUME_TOL = 3e-5     # grad_norm of a resumed step vs the live one
#                             (the backward's atomics: 9.7e-8 to 6.9e-6)
RESUME_MOMENT_TOL = 1e-3    # exp_avg rel-L2 of a resumed step vs the live
#                             one (the backward's atomics: 1.8e-4)
GRAD_TOLS = (1e-2, 1e-2, 1e-1)  # phase 17, GPU vs CPU, rel-L2 of the
#                                 gradient and AdamW's first moment: whole,
#                                 median tensor, worst tensor (2.5-6x the
#                                 readings and the control's: PERF.md)
SQ_TOLS = (1e-2, 2e-2, 1e-1)    # AdamW's second moment, ~g^2
UPDATE_LR_TOL = 1e-5        # phase 17: the step's update against AdamW's
#                             formula on its own moments, in learning rates
#                             (1.8e-7 on the H100)
EVAL_TIMED = 5              # eval samples timed a precision, phases 19-20
RAYIOU_TOL = 1e-4           # phase 21: RayIoU, card against the CPU
RAY_MOVED_MAX = 1e-4        # phase 21: share of rays that may hit another
#                             voxel on the card than on the CPU (a direction
#                             one ulp off can flip the DDA's strict `<`)
DVR_TOL = 1e-4              # phase 21: dvr.render card vs CPU, of the peak
#                             of pred_dist and of grad_sigma (the card's
#                             gradient sums by atomics, in no fixed order),
#                             on all but RAY_MOVED_MAX of the rays / voxels
# the share of voxels whose argmax may flip under int8 serving (JAX's own
# test bound, tests/test_quant.py); the v5e read 0.4905% (README.md)
INT8_FLIP_MAX = 0.02
INT8_FLIP_V5E = 0.004905
EXPORT_FRAMES = 5           # frames of each loaded program timed, 23-24
DDP_STEPS = 2               # phase 26: train steps with and without a group
# phase 26, the same two DHD-S bf16 steps in a group of one and without:
# the first step's losses and BatchNorm statistics bit for bit (a forward
# is deterministic and a group of one sums nothing); grad_norm and the
# second step, which starts from the first's update, within DDP_SPREAD
# times the spread of two runs without a group (the backward's atomics)
# plus DDP_FLOOR
DDP_SPREAD = 4.0
DDP_FLOOR = 1e-7


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_lines(log: str) -> list:
    """nvcc's ``-Xptxas -v`` report, one line per kernel: its mangled name
    (template arguments included), registers, shared memory and spills."""
    found: dict = {}
    name = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("registers" in ln or "spill" in ln):
            found.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return [f"{k}: {', '.join(v)}" for k, v in found.items()]


def short_ptxas(lines: list, kernel: str) -> list:
    """The ptxas lines of ``kernel``'s instantiations, each named by its
    template arguments (``<32, 9>``, ``<13__nv_bfloat16, 256, 1>``)."""
    out = []
    for ln in lines:
        m = re.match(rf".*{kernel}I(.*?)EEvP.*?: (.*)", ln)
        if m:
            args = re.sub(r"Li(\d+)E?", r", \1", m.group(1)).strip(", ")
            out.append(f"<{args}>: {m.group(2)}")
    return out


def time_ms(fn, iters: int = 30, warmup: int = 3, busy: bool = True
            ) -> float:
    """Median time of one call, by CUDA events around each call.  With
    ``busy`` a sleep kernel ahead of the start event keeps the device busy
    while the host enqueues the call, so the time between the events is
    the device's alone.  Without it the device idles until the call's
    first kernel arrives, and the time also holds the host's work before
    that launch (the wrapper's Python, the dispatch, the launch itself)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if busy:
            torch.cuda._sleep(SLEEP_CYCLES)
        else:
            torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, iters: int = 50, warmup: int = 3) -> float:
    """Host time of one call in microseconds, from its start to its
    return, with the device kept busy by a sleep kernel so that the call
    never waits for it: what the call costs the host per launch.  The
    least of ``iters`` calls, its own cost: the median follows whatever
    else the machine's shared cores run (2-5x between runs on one card)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * min(times)


def bf16_ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def rel_to_peak(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(1e-3, float(b.abs().max()))


def sum_error_share(y_k, y_p, terms, atol=None) -> float:
    """The largest |y_k - y_p| as a share of one bf16 ulp of y_p (or of
    ``atol``) plus ``TERM_TOL`` of ``terms``, the summed magnitudes behind
    each output."""
    yp = y_p.float()
    ulp = atol if atol is not None else torch.where(
        yp == 0, 0.0, torch.exp2(torch.floor(torch.log2(yp.abs())) - 7))
    tol = ulp + TERM_TOL * terms.float()
    diff = (y_k.float() - yp).abs()
    return float(torch.where(diff > 0, diff / tol, 0.0).max())


def pool_indices(dev, preset):
    """The (vt, PoolIndices, cams shape) that :func:`pool_case` plans from:
    DHD-S's rig, DHD-M's or DHD-L's streamed frame (its frame-relative
    sensor2keyego), or ``hot``: DHD-S's with the first 10% of the frustum
    points (in (B, N, D, fH, fW) order) moved into one pillar near the
    ego, their heights kept."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.geometry import create_frustum, frustum_to_ego
    from dhd_tpu_torch.models.dhd import GEOM_KEYS
    from dhd_tpu_torch.models.dhd_stereo import stream_geometry
    from dhd_tpu_torch.ops import compute_pool_indices

    cfg = get_config("dhd_s" if preset == "hot" else preset)
    vt = cfg.vt
    def geom(k):
        return torch.as_tensor(np.asarray(batch[k]), dtype=torch.float32,
                               device=dev)

    if cfg.temporal:
        batch = stream_frames(cfg, 1)[0]
        s2k = stream_geometry(geom("sensor2ego"), geom("ego2global"))[0]
        batch = dict(batch, sensor2keyego=s2k.cpu())
    else:
        batch = synthetic_batch(cfg, batch_size=1, seed=0, with_gt=False)
    frustum = create_frustum(vt.depth, vt.input_size, vt.downsample, vt.sid,
                             device=dev)
    coords = frustum_to_ego(frustum, *(geom(k) for k in GEOM_KEYS))
    if preset == "hot":
        flat = coords.clone().view(-1, 3)
        n_hot = flat.shape[0] // 10
        flat[:n_hot, 0] = vt.x.lower + (vt.x.size // 2 + 0.5) * vt.x.interval
        flat[:n_hot, 1] = vt.y.lower + (vt.y.size // 2 + 0.5) * vt.y.interval
        coords = flat.view(coords.shape)
    return vt, compute_pool_indices(coords, vt), tuple(coords.shape[:-1])


def pillar_histogram(plan) -> dict:
    """Points per non-empty pillar: mean, p99, max, and the pillars of more
    than 256 points (one warp's share of B1)."""
    n = (plan.starts[1:] - plan.starts[:-1]).float()
    n = n[n > 0]
    return {"pillars": int(n.numel()), "mean": float(n.mean()),
            "p99": float(torch.quantile(n, 0.99)), "max": int(n.max()),
            "over_256": int((n > 256).sum())}


def pool_case(dev, preset):
    """B1's inputs at the geometry of ``preset``: DHD-S (the single-frame
    plan, D=44), DHD-M or DHD-L (the streamed frame's plan, as the
    streaming step pools it, D=88), or ``hot`` (:func:`pool_indices`);
    softmaxed bf16 depth, unit-normal features and one-hot band gates (a
    quarter of the pixels gated off) from seed 1.  Returns the config, the
    plan and the kernel's arguments."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.models import (build_batch_pool_plan,
                                      build_stream_pool_plan)
    from dhd_tpu_torch.ops import build_pool_plan

    cfg = get_config("dhd_s" if preset == "hot" else preset)
    vt = cfg.vt
    if preset == "hot":
        _, idx, shape = pool_indices(dev, "hot")
        plan = build_pool_plan(idx, vt, shape)
    elif cfg.temporal:
        plan = build_stream_pool_plan(cfg, stream_frames(cfg, 1)[0],
                                      device=dev)
    else:
        rig = synthetic_batch(cfg, batch_size=1, seed=0, with_gt=False)
        plan = build_batch_pool_plan(cfg, rig, device=dev)
    fh, fw = vt.feat_size
    px = (1, cfg.num_cams, fh, fw)
    g = torch.Generator(device=dev).manual_seed(1)
    bf16 = torch.bfloat16
    depth = torch.softmax(3 * torch.randn(px + (vt.D,), generator=g,
                                          device=dev), dim=-1).to(bf16)
    feat = torch.randn(px + (vt.out_channels,), generator=g,
                       device=dev).to(bf16)
    band = torch.randint(0, 4, px, generator=g, device=dev)
    band_mask = torch.nn.functional.one_hot(band, 4)[..., :3].to(bf16)
    return cfg, plan, depth, feat, band_mask


def phase_kernel(dev, kernels, preset="dhd_s", ptxas=None, case=None):
    """B1 kernel vs its plain version at the inputs of :func:`pool_case`,
    or of ``case`` (:func:`pool_cases`: a train step's own inputs, in
    fp32 held to POOL_F32_ATOL plus 2^-20 of the terms of the exact
    sums); also B1 with
    the plan built in the call, as a frame without a cached plan pools.
    Returns the plan."""
    from dhd_tpu_torch.ops import (build_pool_plan, mghs_pool_cuda,
                                   mghs_pool_plan_plain)

    cfg, plan, depth, feat, band_mask, keys = case or (
        pool_case(dev, preset) + (None,))
    fp32 = depth.dtype == torch.float32
    vt = cfg.vt
    before = mghs_pool_cuda.launches
    bev_k, vox_k = mghs_pool_cuda(depth, feat, band_mask, plan)
    bev_2, vox_2 = mghs_pool_cuda(depth, feat, band_mask, plan)
    torch.cuda.synchronize()
    check(mghs_pool_cuda.launches == before + 2, "kernel launch not counted")
    check(torch.equal(bev_k, bev_2) and torch.equal(vox_k, vox_2),
          f"mghs_pool_cuda at {preset}: two calls differ")
    del bev_2, vox_2
    bev_p, vox_p = mghs_pool_plan_plain(depth, feat, band_mask, plan)
    # the sums of |d * feat|: the scale of each output's fp32 terms
    bev_a, vox_a = mghs_pool_plan_plain(depth, feat.abs(), band_mask, plan)
    torch.cuda.synchronize()
    err = max(float((bev_k.float() - bev_p.float()).abs().max()),
              float((vox_k.float() - vox_p.float()).abs().max()))
    atol = POOL_F32_ATOL if fp32 else None
    share = max(sum_error_share(bev_k, bev_p, bev_a, atol),
                sum_error_share(vox_k, vox_p, vox_a, atol))
    if fp32:
        # in fp32 the plain version's index_add_ rounds about as much as
        # the kernel, in the order its atomics take (the line prints both
        # against exact sums): hold the kernel to the plain version's exact
        # sums of the same products
        exact = mghs_pool_plan_plain(depth, feat, band_mask, plan,
                                     acc_dtype=torch.float64)
        own = max(sum_error_share(bev_k, exact[0], bev_a, atol),
                  sum_error_share(vox_k, exact[1], vox_a, atol))
        plain_own = max(sum_error_share(bev_p, exact[0], bev_a, atol),
                        sum_error_share(vox_p, exact[1], vox_a, atol))
        del exact
        check(own <= 1, f"mghs_pool_cuda fp32 at {preset} differs from "
              f"the plain version's exact sums by {own:.3f} of "
              f"{POOL_F32_ATOL} plus 2^-20 of the terms")
        bar = (f"{own:.3f} of {POOL_F32_ATOL} plus 2^-20 of the terms from "
               f"the exact sums (tol 1; the fp32 plain version "
               f"{plain_own:.3f}, kernel vs fp32 plain {share:.3f})")
    else:
        ulps = max(bf16_ulp_diff(bev_k, bev_p),
                   bf16_ulp_diff(vox_k, vox_p))
        # DHD-L's pillars sum ~4x DHD-M's points, and a sum that nearly
        # cancels is many of its own bf16 ulps off for an fp32-level
        # difference: there the bar is one ulp plus 2^-20 of the terms'
        # magnitudes
        check(ulps <= POOL_ULP_TOL
              or (preset.startswith("dhd_l") and share <= 1),
              f"mghs_pool_cuda differs from plain by {ulps} bf16 ulps "
              f"({share:.3f} of one ulp plus 2^-20 of the terms)")
        bar = (f"max {ulps} bf16 ulp (tol {POOL_ULP_TOL}), {share:.3f} of "
               f"one ulp plus 2^-20 of the terms")
    check(float(vox_k.float().abs().sum()) > 0, "vox is all zero")
    del bev_p, vox_p, bev_a, vox_a

    ms = time_ms(lambda: mghs_pool_cuda(depth, feat, band_mask, plan))
    plain_ms = time_ms(
        lambda: mghs_pool_plan_plain(depth, feat, band_mask, plan))
    call_us = host_us(lambda: mghs_pool_cuda(depth, feat, band_mask, plan))
    # device memory one call takes beyond its inputs: the outputs, and any
    # scratch the kernel allocates
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    mghs_pool_cuda(depth, feat, band_mask, plan)
    torch.cuda.synchronize()
    call_mb = (torch.cuda.max_memory_allocated() - held) / 1e6
    # the uncached path: sort, plan and pool in the call; device time, the
    # time on an idle card (the host's enqueueing included) and host time
    _, idx, shape = keys or pool_indices(dev, preset)

    def uncached():
        return mghs_pool_cuda(depth, feat, band_mask,
                              build_pool_plan(idx, vt, shape))
    cold = (time_ms(uncached), time_ms(uncached, busy=False),
            host_us(uncached))

    # least time: each input read once, each output written once; the
    # sorted-point work counts only the points inside the grid
    n_valid = int(plan.starts[-1])
    z = plan.z_s[:n_valid].long()
    pix = plan.dix_s[:n_valid].long() // vt.D
    e0, e1 = plan.band_edges
    bnd = (z >= e0).long() + (z >= e1).long()
    n_gated = int(((z >= 0)
                   & (band_mask.reshape(-1, 3)[pix, bnd] > 0)
                   ).sum())
    hist = pillar_histogram(plan)
    c = vt.out_channels
    nbytes = (depth.element_size() * (
        vox_k.numel() + bev_k.numel() + depth.numel() + feat.numel()
        + band_mask.numel()) + 8 * n_valid + 4 * plan.starts.numel())
    flops = n_valid * c * 2 + n_gated * c      # multiply + bev add; vox add
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    measured = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "host_us": call_us, "points_per_pillar": hist,
        "call_peak_mb": call_mb, "plan_in_call_ms": cold[0],
        "plan_in_call_idle_ms": cold[1], "plan_in_call_host_us": cold[2]}
    # the top-level numbers are DHD-S's, each shape's are under "shapes";
    # max_abs_err is the largest over the shapes
    kern = kernels.setdefault("mghs_pool_cuda", dict(
        {"name": "mghs_pool_cuda", "route": "cuda",
         "source": "dhd_tpu_torch/csrc/mghs_pool.cu",
         "replaces": "dhd_tpu/ops/pallas_pool.py:240", "launches": None},
        **measured, library_ms=None, shapes={}))
    kern["shapes"][preset] = measured
    kern["max_abs_err"] = max(kern["max_abs_err"], err)
    print(f"phase {PHASE_OF[preset]['pool']} ok: mghs_pool_cuda vs "
          f"plain at {preset} (D={vt.D}, C={c}): "
          f"P={plan.dix_s.numel()} points ({n_valid} in grid, {n_gated} "
          f"gated on) -> vox "
          f"{tuple(vox_k.shape)}, bev {tuple(bev_k.shape)} "
          f"{str(depth.dtype)[6:]}; two calls bit-identical; max abs err "
          f"{err:.3e}, {bar}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{measured['bound_ms']:.4f} ms ({measured['bound_by']}, "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP; "
          f"{measured['bound_ms'] / ms:.3f} of the kernel's time); least "
          f"host time per call {call_us:.1f} us; points per non-empty "
          f"pillar ({hist['pillars']}): mean {hist['mean']:.1f}, p99 "
          f"{hist['p99']:.0f}, max {hist['max']}, {hist['over_256']} "
          f"pillars over 256; one call's peak memory {call_mb:.1f} MB "
          f"(outputs {vox_k.nbytes / 1e6 + bev_k.nbytes / 1e6:.1f} MB); "
          f"plan built in the call: {cold[0]:.4f} ms device, {cold[1]:.4f} "
          f"ms on an idle card, {cold[2]:.0f} us host"
          + ("; ptxas <type, channels per lane>: " + "; ".join(
              f"{kind} {ln}" for kind in ("mghs_pool", "mghs_pool_combine")
              for ln in short_ptxas(ptxas.get("mghs_pool", []),
                                    f"{kind}_kernel")) if ptxas else ""),
          flush=True)
    return plan


def phase_plan(dev, kernels, preset, plan, keys=None):
    """B1's plan kernels (``pool_plan_cuda``: the sorted points' tables and
    the first pass's schedule, built with every plan on the card, so every
    frame of the uncached path) vs their plain version on ``preset``'s
    sorted keys: every table and list must be equal, and equal to
    ``plan``'s (:func:`pool_case`'s).  Also the scratch the split pillars
    take: the shapes' bound, which a plan built in the call allocates,
    against the slots used, which a plan built once per rig counts.
    ``keys``: the (vt, PoolIndices, cams shape) to plan from, in place of
    :func:`pool_indices`'s."""
    from dhd_tpu_torch.ops.mghs_pool_cuda import (pool_plan_cuda,
                                                  pool_plan_plain)

    vt, idx, shape = keys or pool_indices(dev, preset)
    key_s, order = torch.sort(idx.key, stable=True)
    args = (key_s, order, idx.seg_vox, idx.num_seg_vox, shape,
            vt.z_fine.size)
    before = pool_plan_cuda.launches
    got = pool_plan_cuda(*args)
    want = pool_plan_plain(*args)
    torch.cuda.synchronize()
    check(pool_plan_cuda.launches == before + 1, "plan launch not counted")
    check(all(g.shape == w.shape for g, w in zip(got[:5], want[:5]))
          and got[5] == want[5], f"pool_plan_cuda at {preset}: shapes differ")
    err = max(float((g.long() - w.long()).abs().max()) if g.numel() else 0.0
              for g, w in zip(got[:5], want[:5]))
    check(err == 0, f"pool_plan_cuda at {preset}: differs from plain by up "
          f"to {err}")
    check(all(torch.equal(g, w) for g, w in zip(got, (
        plan.dix_s, plan.z_s, plan.starts, plan.tasks, plan.splits))),
        f"pool_plan_cuda at {preset}: not the served plan")
    ms = time_ms(lambda: pool_plan_cuda(*args))
    plain_ms = time_ms(lambda: pool_plan_plain(*args))
    call_us = host_us(lambda: pool_plan_cuda(*args))
    plain_us = host_us(lambda: pool_plan_plain(*args))
    dix_s, _, starts, tasks, splits, bound = got
    p, n_pillars = key_s.numel(), starts.numel() - 1
    # least time: the sorted keys, the order and seg_vox read once, the
    # tables and lists written once
    nbytes = 24 * p + 4 * starts.numel() + 16 * (tasks.shape[0]
                                                 + splits.shape[0])
    used = int(splits[:, 2].sum())
    n_real = int((tasks[:, 0] < n_pillars).sum())
    slot_mb = (vt.z_fine.size + 1) * vt.out_channels * 4 / 1e6
    measured = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                "bound_by": "bytes", "host_us": call_us,
                "plain_host_us": plain_us, "slots_bound": bound,
                "slots_used": used, "plan_slots": plan.n_slots}
    kern = kernels.setdefault("pool_plan_cuda", dict(
        {"name": "pool_plan_cuda", "route": "cuda",
         "source": "dhd_tpu_torch/csrc/mghs_pool.cu",
         "replaces": "dhd_tpu/ops/pallas_pool.py:240", "launches": None},
        **measured, library_ms=None, shapes={}))
    kern["shapes"][preset] = measured
    kern["max_abs_err"] = max(kern["max_abs_err"], err)
    print(f"phase {PHASE_OF[preset]['pool']} ok: pool_plan_cuda vs plain at "
          f"{preset}: {n_pillars} pillars, P={p}: {n_real} tasks of "
          f"{tasks.shape[0]} rows, {int((splits[:, 0] < n_pillars).sum())} "
          f"split pillars of {splits.shape[0]} rows; tables and lists equal "
          f"(and equal to the served plan's); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {measured['bound_ms']:.4f} ms (bytes, "
          f"{nbytes / 1e6:.2f} MB); least host time per call {call_us:.1f} "
          f"us (plain {plain_us:.1f}); scratch slots: {used} used "
          f"({used * slot_mb:.1f} MB), bound {bound} "
          f"({bound * slot_mb:.1f} MB), this plan's {plan.n_slots}",
          flush=True)


def phase_serve(dev, kernels, card):
    """DHD-S serving: 5 frames of one rig through the cached-plan path."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.models import DHDNet, build_batch_pool_plan
    from dhd_tpu_torch.ops import mghs_pool_cuda

    cfg = get_config("dhd_s")
    bf16 = torch.bfloat16
    model = DHDNet(cfg, dtype=bf16, device=dev,
                   generator=torch.Generator().manual_seed(0))
    rig = synthetic_batch(cfg, batch_size=1, seed=0, with_gt=False)
    plan = build_batch_pool_plan(cfg, rig, device=dev)
    frames = [dict(rig, pool_plan=plan, imgs=np.random.default_rng(100 + k)
                   .normal(0, 1, rig["imgs"].shape).astype(np.float32))
              for k in range(6)]

    t0 = time.perf_counter()
    model(frames[0])                               # warm-up frame
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    mghs_pool_cuda.launches = 0
    frame_ms, outs = [], []
    for frame in frames[1:]:
        t0 = time.perf_counter()
        out = model(frame)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        outs.append(out["occ_logits"])
    launches = mghs_pool_cuda.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernels["mghs_pool_cuda"]["launches_by_path"] = {
        "dhd_s_serve": launches}
    check(launches == 5, f"mghs_pool_cuda launched {launches} times, want 5")
    want = (1, cfg.vt.x.size, cfg.vt.y.size, cfg.head_Dz, cfg.num_classes)
    for occ in outs:
        check(tuple(occ.shape) == want, f"occ_logits {tuple(occ.shape)}")
        check(bool(torch.isfinite(occ).all()), "occ_logits not finite")
    check(rel_to_peak(outs[0], outs[1]) > 0, "frames gave equal outputs")

    plain = DHDNet(dataclasses.replace(cfg, pool_method="xla"), dtype=bf16,
                   device=dev, generator=torch.Generator().manual_seed(0))
    plain.load_state_dict(model.state_dict())
    occ_p = plain(frames[1])["occ_logits"]
    rel = rel_to_peak(outs[0], occ_p)
    agree = float((outs[0].argmax(-1) == occ_p.argmax(-1)).float().mean())
    check(mghs_pool_cuda.launches == 5, "plain path launched the kernel")
    check(rel <= SERVE_REL_TOL and agree >= SERVE_ARGMAX_MIN,
          f"kernel vs plain serving: rel err {rel:.3e} (tol "
          f"{SERVE_REL_TOL}), argmax agreement {agree:.6f} (min "
          f"{SERVE_ARGMAX_MIN})")
    print(f"phase 3 ok: DHD-S bf16 served 5 frames, occ_logits {want}, "
          f"finite; mghs_pool_cuda launches {launches}; "
          f"{statistics.median(frame_ms):.2f} ms/frame median "
          f"(frames {', '.join(f'{t:.2f}' for t in frame_ms)}; warm-up "
          f"{warm_ms:.1f} ms), peak memory {peak_gb:.2f} GB; plain pooling "
          f"forced: rel-to-peak err {rel:.3e} (tol {SERVE_REL_TOL}), argmax "
          f"agreement {agree:.6f} (min {SERVE_ARGMAX_MIN}); on {card}",
          flush=True)

    plain_ms = []
    for frame in frames[1:]:
        t0 = time.perf_counter()
        plain(frame)
        torch.cuda.synchronize()
        plain_ms.append(1e3 * (time.perf_counter() - t0))
    stages = stage_ms(model, lambda: model(frames[1]))
    busy, top, trace = device_busy_ms(lambda: model(frames[1]))
    n_sync, sync_at = host_syncs(lambda: model(frames[1]))
    frame = statistics.median(frame_ms)
    print(f"phase 3 breakdown: plain-pooling path "
          f"{statistics.median(plain_ms):.2f} ms/frame median vs kernel path "
          f"{frame:.2f}; host syncs per frame {n_sync} "
          f"({trace['frame']['sync_host_ms']:.2f} ms in synchronize calls) "
          f"at {sync_at}; stage device ms (CUDA events) "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + (f"; device busy {busy:.2f} ms of {frame:.2f} ms/frame, idle "
             f"share {1 - busy / frame:.3f}; top kernels (ms) "
             + ", ".join(f"{n[:48]} {t:.3f}" for n, t in top)
             if busy > 0 else "; device busy: not measured (no device "
             "time in the profiler)"), flush=True)
    del model, plain


def phase_serve_uncached(dev, card, counted=(), n_frames: int = 20):
    """DHD-S frames without the cached plan, as ``cli --what full`` serves
    them: each frame sorts and plans its points in the call.  The median
    frame (host wall time to a synchronize), one frame's device busy time
    and its host syncs.  B1 and each wrapper in ``counted`` must launch
    once a frame; returns their launches over the frames."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.models import DHDNet
    from dhd_tpu_torch.ops import mghs_pool_cuda

    cfg = get_config("dhd_s")
    model = DHDNet(cfg, dtype=torch.bfloat16, device=dev,
                   generator=torch.Generator().manual_seed(0))
    rig = synthetic_batch(cfg, batch_size=1, seed=0, with_gt=False)
    frames = [dict(rig, imgs=np.random.default_rng(100 + k).normal(
        0, 1, rig["imgs"].shape).astype(np.float32))
        for k in range(n_frames + 1)]
    model(frames[0])                               # warm-up frame
    torch.cuda.synchronize()
    counted = (mghs_pool_cuda, *counted)
    for fn in counted:
        fn.launches = 0
    frame_ms = []
    for frame in frames[1:]:
        t0 = time.perf_counter()
        out = model(frame)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        check(bool(torch.isfinite(out["occ_logits"]).all()),
              "occ_logits not finite")
    launches = {fn.__name__: fn.launches for fn in counted}
    check(all(n == n_frames for n in launches.values()),
          f"launches {launches} in {n_frames} frames")
    busy, top, _ = device_busy_ms(lambda: model(frames[1]))
    n_sync, sync_at = host_syncs(lambda: model(frames[1]))
    frame = statistics.median(frame_ms)
    print(f"phase 3 uncached: DHD-S bf16, {n_frames} frames planned in the "
          f"call: {frame:.2f} ms/frame median (least "
          f"{min(frame_ms):.2f}, most {max(frame_ms):.2f}); device busy "
          f"{busy:.2f} ms a frame; host syncs per frame {n_sync} at "
          f"{sync_at}; launches {launches}; on {card}", flush=True)
    del model
    return launches


def stage_ms(model, run, extra=()) -> dict:
    """Device time of each top-level stage of one frame (``run()``): CUDA
    events recorded by forward hooks around every child module, and around
    the model methods named in ``extra``.  A stage called more than once
    sums its calls."""
    events: dict = {}

    def record(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.setdefault(name, []).append(ev)

    def timed(name, fn):
        def call(*args, **kwargs):
            record(name)
            out = fn(*args, **kwargs)
            record(name)
            return out
        return call

    hooks = []
    for name, mod in model.named_children():
        hooks.append(mod.register_forward_pre_hook(
            lambda *_, n=name: record(n)))
        hooks.append(mod.register_forward_hook(lambda *_, n=name: record(n)))
    for name in extra:
        setattr(model, name, timed(name.strip("_"), getattr(model, name)))
    record("frame")
    run()
    record("frame")
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    for name in extra:
        delattr(model, name)
    return {n: sum(ev[i].elapsed_time(ev[i + 1])
                   for i in range(0, len(ev), 2))
            for n, ev in events.items()}


def device_busy_ms(run, n_top: int = 6, model=None, ranges=()):
    """Summed device time of one frame or step (``run()``) from
    ``dhd_tpu_torch.profiling.trace_device``, the kernels that take most
    of it, and the trace's reading of each model method named in
    ``ranges`` (wrapped in a profiler range for this run: its host ms, its
    span on the device, the kernel time inside that span, and the CUDA
    synchronize calls the host made in it), with the whole run's
    synchronize calls under ``"frame"``."""
    from torch.profiler import record_function

    from dhd_tpu_torch.profiling import top_ops, trace_device

    def in_range(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    for name in ranges:
        setattr(model, name, in_range(name.strip("_"), getattr(model, name)))
    try:
        prof = trace_device(run, torch.device("cuda"))
    finally:
        for name in ranges:
            delattr(model, name)
    readings = {name.strip("_"): prof["ranges"][name.strip("_")]
                for name in ranges if name.strip("_") in prof["ranges"]}
    readings["frame"] = prof["syncs"]
    return (sum(prof["ops"].values()),
            [(n, t) for n, t, _ in top_ops(prof, n_top)], readings)


def host_syncs(run, n_top: int = 8):
    """Host waits for the device in one frame (``run()``), counted by
    ``torch.cuda.set_sync_debug_mode``: the total and the source lines
    that cause most of them."""
    import collections
    import os
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice ("Synchronization debug mode is a prototype
    # feature", once a process) is no sync
    where = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)
        and "prototype" not in str(w.message))
    return sum(where.values()), where.most_common(n_top)


def phase_tiny(dev):
    """dhd_tiny in fp32: GPU kernel path vs CPU plain path, same weights."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.models import DHDNet

    cfg = get_config("dhd_tiny")
    gpu = DHDNet(cfg, device=dev, generator=torch.Generator().manual_seed(3))
    cpu = DHDNet(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    batch = synthetic_batch(cfg, batch_size=2, seed=4, with_gt=False)
    out_g, out_c = gpu(batch), cpu(batch)
    errs = {k: rel_to_peak(out_g[k].cpu(), out_c[k])
            for k in ("occ_logits", "depth", "height")}
    check(all(e < TINY_REL_TOL for e in errs.values()),
          f"dhd_tiny GPU vs CPU: {errs} (tol {TINY_REL_TOL})")
    print("phase 4 ok: dhd_tiny fp32 GPU vs CPU, rel-to-peak err "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
          + f" (tol {TINY_REL_TOL})", flush=True)


def stream_frames(cfg, n_frames: int, seed: int = 0):
    """Streamed frames of one synthetic rig: new random images per frame,
    the ego 0.5 m further along +x each frame."""
    from dhd_tpu_torch.data import synthetic_batch

    rig = synthetic_batch(cfg, batch_size=1, seed=seed, with_gt=False)
    frames = []
    for k in range(n_frames):
        e2g = rig["ego2global"][:, 0].copy()
        e2g[..., 0, 3] += 0.5 * k
        frames.append({
            "imgs": np.random.default_rng(100 + k).normal(
                0, 1, rig["imgs"][:, 0].shape).astype(np.float32),
            "sensor2ego": rig["sensor2ego"][:, 0], "ego2global": e2g,
            "intrins": rig["intrins"][:, 0],
            "post_rots": rig["post_rots"][:, 0],
            "post_trans": rig["post_trans"][:, 0], "bda": rig["bda"]})
    return frames


def cv_inputs(dev, preset):
    """B3's inputs at the geometry of ``preset``: the plan of a rig moving
    0.5 m forward with 0.6 deg of yaw, and rectified bf16 stereo features
    of the preset's width (DHD-M: ResNet-50 layer1, C=256; DHD-L: Swin-B
    stage 0, C=128).  Returns prev, curr, uf, vf and the preset's bias."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.geometry import create_frustum, rigid_relative
    from dhd_tpu_torch.models import stereo_feat_channels, stream_geometry
    from dhd_tpu_torch.ops import build_cv_plan

    cfg = get_config(preset)
    vt = cfg.vt
    hs, ws = vt.input_size[0] // 4, vt.input_size[1] // 4
    prev_f, curr_f = stream_frames(cfg, 2)
    # 0.5 m forward and 0.6 deg of yaw between the frames
    yaw = np.deg2rad(0.6)
    e2g = curr_f["ego2global"].copy()
    e2g[..., :2, :2] = [[np.cos(yaw), -np.sin(yaw)],
                        [np.sin(yaw), np.cos(yaw)]]

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    _, c2g_prev = stream_geometry(t(prev_f["sensor2ego"]),
                                  t(prev_f["ego2global"]))
    _, c2g_curr = stream_geometry(t(curr_f["sensor2ego"]), t(e2g))
    k2s = rigid_relative(c2g_prev, c2g_curr)
    frustum = create_frustum(vt.depth, vt.input_size, 4, vt.sid, device=dev)
    uf, vf = build_cv_plan(frustum, k2s, t(curr_f["intrins"]),
                           t(curr_f["post_rots"]), t(curr_f["post_trans"]),
                           hs, ws)
    c = stereo_feat_channels(cfg)
    g = torch.Generator(device=dev).manual_seed(5)
    prev, curr = (torch.relu(torch.randn((uf.shape[0], hs, ws, c),
                                         generator=g, device=dev)
                             ).to(torch.bfloat16)
                  for _ in range(2))
    return prev, curr, uf, vf, cfg.depthnet_cfg.bias


def warp0_exact(prev, uf, vf, idx):
    """Channel 0 of ``prev`` warped bilinearly (zero padding) to the
    samples ``idx`` (index tensors over (BN, D, Hs, Ws)) in float64, and
    the sum of its terms' magnitudes."""
    bn, hs, ws, _ = prev.shape
    b = idx[0]
    u, v = uf[idx].double(), vf[idx].double()
    x0, y0 = torch.floor(u), torch.floor(v)
    val, terms = torch.zeros_like(u), torch.zeros_like(u)
    for dy, wy in ((0, 1 - (v - y0)), (1, v - y0)):
        for dx, wx in ((0, 1 - (u - x0)), (1, u - x0)):
            yy, xx = y0.long() + dy, x0.long() + dx
            inside = (yy >= 0) & (yy < hs) & (xx >= 0) & (xx < ws)
            t = prev[b, yy.clamp(0, hs - 1), xx.clamp(0, ws - 1), 0]
            t = torch.where(inside, t.double() * wx * wy, 0.0)
            val, terms = val + t, terms + t.abs()
    return val, terms


def phase_cost_volume(dev, kernels, preset="dhd_m", ptxas=None, case=None):
    """B3 kernel vs its plain version at the geometry of ``preset``: the
    stride-4 stereo feature of DHD-M (ResNet-50 layer1, C=256) or DHD-L
    (Swin-B stage 0, C=128); or at ``case``, the (prev, curr, uf, vf,
    bias) a train step gave it (:func:`record_train_step`)."""
    from dhd_tpu_torch.ops import cv_cost_plain, stereo_cost_volume_cuda

    prev, curr, uf, vf, bias = case or cv_inputs(dev, preset)
    bn, _, hs, ws = uf.shape
    c = prev.shape[-1]

    before = stereo_cost_volume_cuda.launches
    cost_k = stereo_cost_volume_cuda(prev, curr, uf, vf, bias)
    torch.cuda.synchronize()
    check(stereo_cost_volume_cuda.launches == before + 1,
          "kernel launch not counted")
    cost_p = cv_cost_plain(prev, curr, uf, vf, bias)
    no_bias = cv_cost_plain(prev, curr, uf, vf, 0.0)
    torch.cuda.synchronize()
    err = float((cost_k - cost_p).abs().max())
    hit_p = (cost_p - no_bias) > bias / 2
    hit_k = (cost_k - no_bias) > bias / 2
    # the bias goes where the warped channel 0 is exactly 0: the two may
    # part only where the exact warped value is within fp32 rounding
    # (TERM_TOL) of its terms, zero in one order of the fp32 sum only
    flipped = hit_p != hit_k
    flips = flipped.nonzero(as_tuple=True)
    n_flips = flips[0].numel()
    if n_flips:
        near, terms = warp0_exact(prev, uf, vf, flips)
        # no terms (every tap off the image or zero): 0 in any order
        flip_share = float(torch.where(terms > 0, near.abs() / terms,
                                       math.inf).max())
        check(flip_share <= TERM_TOL, f"bias landed on {n_flips} other "
              f"samples, the exact warped channel 0 there up to "
              f"{flip_share:.3e} of its terms (tol 2^-20)")
    # a pixel's depth softmax holds by the bar where both put the bias on
    # the same samples; a pixel with a sample held above is moved by it
    same = ~flipped.any(1, keepdim=True)
    p_k, p_p = torch.softmax(-cost_k, 1), torch.softmax(-cost_p, 1)
    prob_err = float(((p_k - p_p).abs() * same).max())
    check(bool((((p_k - p_p).abs() <= CV_ATOL + CV_RTOL * p_p.abs())
                | ~same).all()),
          f"stereo_cost_volume_cuda probabilities differ from plain by "
          f"{prob_err:.3e} (atol {CV_ATOL}, rtol {CV_RTOL})")
    off = uf < -1e3
    n_off = int(off.sum())
    n_valid = off.numel() - n_off
    share_invalid = float(hit_p.float().mean())
    share_zero = float((hit_p & ~off).float().mean())

    ms = time_ms(lambda: stereo_cost_volume_cuda(prev, curr, uf, vf, bias))
    plain_ms = time_ms(lambda: cv_cost_plain(prev, curr, uf, vf, bias),
                       iters=5, warmup=1)
    call_us = host_us(lambda: stereo_cost_volume_cuda(prev, curr, uf, vf,
                                                      bias))
    # least time: features, plan and cost each moved once; fp32 flops of
    # the samples this rig needs
    nbytes = (prev.element_size() * (prev.numel() + curr.numel())
              + 4 * (uf.numel() + vf.numel() + cost_k.numel()))
    flops = c * (CV_FLOPS_VALID * n_valid + CV_FLOPS_OFF * n_off)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    measured = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "host_us": call_us}
    measured["bound_share"] = measured["bound_ms"] / ms
    # the top-level numbers are DHD-M's, each shape's are under "shapes"
    kern = kernels.setdefault("stereo_cost_volume_cuda", dict(
        {"name": "stereo_cost_volume_cuda", "route": "cuda",
         "source": "dhd_tpu_torch/csrc/cost_volume.cu",
         "replaces": "dhd_tpu/ops/cost_volume_pallas.py:74",
         "launches": None}, **measured, library_ms=None, shapes={}))
    kern["shapes"][preset] = measured
    kern["max_abs_err"] = max(kern["max_abs_err"], err)
    print(f"phase {PHASE_OF[preset]['cv']} ok: stereo_cost_volume_cuda vs "
          f"plain at {preset}: "
          f"({bn}, {uf.shape[1]}, {hs}, {ws}) samples x C={c} "
          f"{str(prev.dtype)[6:]}, bias "
          f"{bias}; max abs cost err {err:.3e} (costs up to "
          f"{float(cost_p.abs().max()):.1f}), max prob err {prob_err:.3e} "
          f"(atol {CV_ATOL}, rtol {CV_RTOL}); invalid share "
          f"{share_invalid:.4f} (off-image {n_off / off.numel():.4f}, "
          f"channel-0 zeros {share_zero:.4f}; "
          + (f"{n_flips} samples apart, the exact warped channel 0 there "
             f"{flip_share:.2e} of its terms, their "
             f"{int((~same).sum())} pixels' probabilities held by that"
             if n_flips else "the same samples")
          + f"); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {measured['bound_ms']:.4f} ms "
          f"({measured['bound_by']}, {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB; {measured['bound_share']:.3f} of the "
          f"kernel's time); least host time per call {call_us:.1f} us; "
          "ptxas <type, lanes per pixel, chunks per lane>: "
          + "; ".join(short_ptxas((ptxas or {}).get("cost_volume", []),
                                  "cost_volume_kernel")), flush=True)


def bf16_ulp_at(x: torch.Tensor) -> float:
    """One bf16 ulp at the peak magnitude of ``x``."""
    return 2.0 ** (float(torch.floor(torch.log2(x.float().abs().max()))) - 7)


def ln_error(y_k, y_p, x, w, b, eps=1e-6):
    """B5 vs plain: the largest distance in bf16 ulps (0 in fp32), and the
    largest error as a share of its tolerance: one bf16 ulp (fp32:
    LN_F32_ATOL) plus ``TERM_TOL`` of the terms, (|x| + mean |x|)·|mul| +
    |bias|.  mean |x| is the magnitude of mu's terms: where a row's
    mean cancels to near 0 (a row already normalised), mu's fp32
    rounding follows mean |x|, not |mu|."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0)
    mul = (torch.rsqrt(var + eps) * w).abs()
    terms = (xf.abs() + xf.abs().mean(-1, keepdim=True)) * mul + b.abs()
    if x.dtype == torch.float32:
        return 0, sum_error_share(y_k, y_p, terms, LN_F32_ATOL)
    return bf16_ulp_diff(y_k, y_p), sum_error_share(y_k, y_p, terms)


def swin_stage_shapes(cfg):
    """Per Swin stage of ``cfg`` at B*N images: (tokens h, w, padded hp, wp,
    C, heads, blocks)."""
    ws = cfg.swin_window
    h, w = cfg.vt.input_size[0] // 4, cfg.vt.input_size[1] // 4
    out = []
    for i, depth in enumerate(cfg.swin_depths):
        out.append((h, w, -(-h // ws) * ws, -(-w // ws) * ws,
                    cfg.swin_embed_dims * 2 ** i, cfg.swin_num_heads[i],
                    depth))
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def time_kernel_and_plain(kern, label, run, plain, library, nbytes, flops,
                          flop_rate, err, frame_count):
    """Times of a kernel (``run``), its plain version and the library call
    on one shape, the shape's bound, under ``kern["shapes"][label]``: the
    device's time (``ms``, ``library_ms``), the time on an idle device
    with the host's work before the launch (``*_with_host``) and the
    host's microseconds per call (``host_us``, ``library_host_us``)."""
    ms = time_ms(run)
    plain_ms = time_ms(plain, iters=10, warmup=2)
    library_ms = time_ms(library)
    ms_host = time_ms(run, busy=False)
    library_ms_host = time_ms(library, busy=False)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    bound_ms = 1e3 * max(t_bytes, t_ops)
    kern["shapes"][label] = measured = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "per_frame": frame_count, "vs_library": ms / library_ms,
        "bound_share": bound_ms / ms, "ms_with_host": ms_host,
        "library_ms_with_host": library_ms_host,
        "vs_library_with_host": ms_host / library_ms_host,
        "host_us": host_us(run), "library_host_us": host_us(library)}
    kern["max_abs_err"] = max(kern["max_abs_err"], err)
    return measured


def timing_line(m, library: str) -> str:
    """A shape's kernel and library times, both readings, for a phase."""
    return (f"kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, "
            f"{library} {m['library_ms']:.4f} ms (kernel/{library} "
            f"{m['vs_library']:.3f}); with the host's work on an idle "
            f"device kernel {m['ms_with_host']:.4f} ms, {library} "
            f"{m['library_ms_with_host']:.4f} ms (kernel/{library} "
            f"{m['vs_library_with_host']:.3f}); least host time per call "
            f"kernel {m['host_us']:.1f} us, {library} "
            f"{m['library_host_us']:.1f} us; bound {m['bound_ms']:.4f} ms "
            f"({m['bound_share']:.3f} of the kernel's device time; "
            f"{m['bound_by']}")


def per_frame_summary(kern) -> str:
    """Launch-weighted kernel and library ms per DHD-L frame over a
    kernel's shapes, under both readings, and the shapes where the kernel
    beats the library."""
    shapes = kern["shapes"].values()
    frame = {k: sum(m["per_frame"] * m[k] for m in shapes)
             for k in ("ms", "library_ms", "bound_ms", "ms_with_host",
                       "library_ms_with_host", "host_us",
                       "library_host_us")}
    wins = sum(m["ms"] < m["library_ms"] for m in shapes)
    wins_host = sum(m["ms_with_host"] < m["library_ms_with_host"]
                    for m in shapes)
    return (f"per DHD-L frame (launch-weighted) kernel {frame['ms']:.3f} ms, "
            f"library {frame['library_ms']:.3f} ms, bound "
            f"{frame['bound_ms']:.3f} ms; with the host's work kernel "
            f"{frame['ms_with_host']:.3f} ms, library "
            f"{frame['library_ms_with_host']:.3f} ms; least host time "
            f"kernel {frame['host_us'] / 1e3:.3f} ms, library "
            f"{frame['library_host_us'] / 1e3:.3f} ms; kernel faster than "
            f"the library at {wins} of {len(kern['shapes'])} shapes by "
            f"device time, at {wins_host} with the host's work")


def attention_library(qkv, bias, mask, heads, n_img):
    """The library call for B4's function: SDPA over (W / n_img, n_img *
    heads, N, hd), the bias + mask of an image's ``n_img`` windows
    broadcast over the images (``mask`` None: no shift)."""
    w, n, c3 = qkv.shape
    hd = c3 // 3 // heads
    q, k, v = (t.contiguous() for t in qkv.reshape(
        w // n_img, n_img, n, 3, heads, hd).permute(3, 0, 1, 4, 2, 5)
        .reshape(3, w // n_img, n_img * heads, n, hd))
    am = (bias[None] + (mask[:, None] if mask is not None else 0)
          ).expand(n_img, heads, n, n).reshape(n_img * heads, n, n)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=am, scale=hd ** -0.5)


def phase_attention(dev, kernels, ptxas):
    """B4 vs plain at DHD-L's four Swin-B stages (6 images, window 12),
    shifted with the real mask and unshifted, and at one shape JAX sends to
    its v1 kernel (3 heads of 32)."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.nn.swin import _shift_attn_mask
    from dhd_tpu_torch.ops import window_attention_cuda, window_attention_plain

    cfg = get_config("dhd_l")
    bn, ws = cfg.num_cams, cfg.swin_window
    n = ws * ws
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(9)
    cases = []
    for i, (_, _, hp, wp, c, heads, depth) in enumerate(
            swin_stage_shapes(cfg)):
        cases += [(f"stage{i}_unshifted", hp, wp, c, heads, (depth + 1) // 2),
                  (f"stage{i}_shifted", hp, wp, c, heads, depth // 2)]
    _, _, hp0, wp0 = swin_stage_shapes(cfg)[0][:4]
    cases.append(("v1_c96_heads3_shifted", hp0, wp0, 96, 3, 0))
    kern = kernels["window_attention_cuda"] = {
        "name": "window_attention_cuda", "route": "cuda",
        "source": "dhd_tpu_torch/csrc/window_attention.cu",
        "replaces": "dhd_tpu/ops/window_attention.py:74",
        "also_replaces": "dhd_tpu/ops/window_attention.py:48",
        "launches": None, "max_abs_err": 0.0, "shapes": {}}
    for label, hp, wp, c, heads, per_frame in cases:
        n_img = (hp // ws) * (wp // ws)
        w, hd = bn * n_img, c // heads
        qkv = torch.randn((w, n, 3 * c), generator=g, device=dev).to(bf16)
        bias = torch.randn((heads, n, n), generator=g, device=dev).to(bf16)
        mask = (torch.from_numpy(_shift_attn_mask(hp, wp, ws, ws // 2))
                .to(dev, bf16) if "_shifted" in label else None)
        before = window_attention_cuda.launches
        out_k = window_attention_cuda(qkv, bias, mask, heads)
        torch.cuda.synchronize()
        check(window_attention_cuda.launches == before + 1,
              "kernel launch not counted")
        out_p = window_attention_plain(qkv, bias, mask, heads)
        err = float((out_k.float() - out_p.float()).abs().max())
        ulps = err / bf16_ulp_at(out_p)
        check(ulps <= ATTN_ULP_TOL, f"window_attention_cuda {label}: "
              f"{ulps:.2f} bf16 ulps of the peak from plain (tol "
              f"{ATTN_ULP_TOL})")
        nbytes = 2 * (qkv.numel() + out_k.numel() + bias.numel()
                      + (mask.numel() if mask is not None else 0))
        flops = w * heads * 4 * n * n * hd
        m = time_kernel_and_plain(
            kern, label, lambda: window_attention_cuda(qkv, bias, mask, heads),
            lambda: window_attention_plain(qkv, bias, mask, heads),
            attention_library(qkv, bias, mask, heads, n_img),
            nbytes, flops, BF16_FLOP_PER_S, err, per_frame)
        print(f"phase 9 ok: window_attention_cuda vs plain at {label} "
              f"(W={w}, N={n}, C={c}, heads={heads}, hd={hd}, bf16): max "
              f"abs err {err:.3e}, {ulps:.2f} bf16 ulps of the peak "
              f"{float(out_p.float().abs().max()):.3f} (tol {ATTN_ULP_TOL});"
              f" {timing_line(m, 'SDPA')}, {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP; on the CUDA cores in fp32 at least "
              f"{1e3 * flops / FP32_FLOP_PER_S:.4f} ms); {per_frame} per "
              f"DHD-L frame", flush=True)
        del qkv, out_k, out_p
    kern.update({key: kern["shapes"]["stage2_shifted"][key]
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by")})
    # <hd, key tiles>: q, k, v, rows padded to hd + 8 bf16
    print(f"phase 9: window_attention_cuda {per_frame_summary(kern)}; "
          "ptxas of the bf16 kernel <hd, most 16-key tiles> (dynamic shared "
          "memory: 3 x 16 x tiles x (hd + 8) bf16): "
          + "; ".join(short_ptxas(ptxas.get("window_attention", []),
                                  "window_attention_mma_kernel")), flush=True)


def phase_layer_norm(dev, kernels, ptxas):
    """B5 vs plain at every (rows, C) of DHD-L's Swin-B: block norms,
    patch-embed and out norms, and the patch merges' at 4C."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.ops import fused_layer_norm_cuda, layer_norm_plain

    cfg = get_config("dhd_l")
    counts: dict = {}
    stages = swin_stage_shapes(cfg)
    for i, (h, w, _, _, c, _, depth) in enumerate(stages):
        rows = cfg.num_cams * h * w
        counts[(rows, c)] = (counts.get((rows, c), 0) + 2 * depth
                             + (i == 0) + (i in cfg.swin_out_indices))
        if i + 1 < len(stages):
            nh, nw = stages[i + 1][:2]
            counts[(cfg.num_cams * nh * nw, 4 * c)] = 1
    kern = kernels["fused_layer_norm_cuda"] = {
        "name": "fused_layer_norm_cuda", "route": "cuda",
        "source": "dhd_tpu_torch/csrc/layer_norm.cu",
        "replaces": "dhd_tpu/ops/layer_norm.py:40",
        "launches": None, "max_abs_err": 0.0, "shapes": {}}
    g = torch.Generator(device=dev).manual_seed(10)
    for (rows, c), per_frame in counts.items():
        label = f"{rows}x{c}"
        x = (3 * torch.randn((rows, c), generator=g, device=dev) + 0.5
             ).to(torch.bfloat16)
        w = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
        b = 0.5 * torch.randn(c, generator=g, device=dev)
        before = fused_layer_norm_cuda.launches
        y_k = fused_layer_norm_cuda(x, w, b)
        torch.cuda.synchronize()
        check(fused_layer_norm_cuda.launches == before + 1,
              "kernel launch not counted")
        y_p = layer_norm_plain(x, w, b)
        ulps, share = ln_error(y_k, y_p, x, w, b)
        err = float((y_k.float() - y_p.float()).abs().max())
        check(share <= 1, f"fused_layer_norm_cuda {label}: error {share:.3f}"
              f" of its tolerance (max {ulps} bf16 ulps) from plain")
        w16, b16 = w.to(x.dtype), b.to(x.dtype)
        nbytes = 2 * 2 * x.numel() + 2 * 4 * c
        m = time_kernel_and_plain(
            kern, label, lambda: fused_layer_norm_cuda(x, w, b),
            lambda: layer_norm_plain(x, w, b),
            lambda: torch.nn.functional.layer_norm(x, (c,), w16, b16, 1e-6),
            nbytes, LN_FLOPS * x.numel(), FP32_FLOP_PER_S, err, per_frame)
        print(f"phase 10 ok: fused_layer_norm_cuda vs plain at {label} bf16:"
              f" max abs err {err:.3e}, max {ulps} bf16 ulps, {share:.3f} "
              f"of the tolerance (1 bf16 ulp + 2^-20 of the terms); "
              f"{timing_line(m, 'F.layer_norm')}, {nbytes / 1e6:.1f} MB); "
              f"{per_frame} per DHD-L frame", flush=True)
    top = max(counts, key=counts.get)
    kern.update({key: kern["shapes"][f"{top[0]}x{top[1]}"][key]
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by")})
    print(f"phase 10: fused_layer_norm_cuda ({sum(counts.values())} "
          f"launches) {per_frame_summary(kern)}; ptxas <type, lanes per row, "
          "chunks per lane>: "
          + "; ".join(short_ptxas(ptxas.get("layer_norm", []),
                                  "layer_norm_kernel")), flush=True)


def stream_kernels(cfg) -> dict:
    """The kernels a streamed frame of ``cfg`` launches, with their launches
    per frame: B1 and B3 once; with a Swin backbone B4 once per block and
    B5 for the patch embed, two per block, each patch merge and each out
    norm (DHD-L: 24 and 54)."""
    from dhd_tpu_torch.ops import (fused_layer_norm_cuda, mghs_pool_cuda,
                                   stereo_cost_volume_cuda,
                                   window_attention_cuda)
    per_frame = {mghs_pool_cuda: 1, stereo_cost_volume_cuda: 1}
    if cfg.backbone == "swin_base":
        blocks = sum(cfg.swin_depths)
        per_frame[window_attention_cuda] = blocks
        per_frame[fused_layer_norm_cuda] = (
            1 + 2 * blocks + len(cfg.swin_depths) - 1
            + len(cfg.swin_out_indices))
    return per_frame


def backbone_drift(model, plain, imgs) -> list:
    """Rel-to-peak difference of each image-backbone output, kernel model
    vs plain model, on the same images: where a bf16 drift starts."""
    b, n, h, w, _ = imgs.shape
    x = torch.as_tensor(imgs, device=model.device).to(model.dtype)
    x = x.permute(0, 1, 4, 2, 3).reshape(b * n, 3, h, w)
    with torch.no_grad():
        return [rel_to_peak(k, p) for k, p in
                zip(model.img_backbone(x), plain.img_backbone(x))]


def phase_stream(dev, kernels, card, preset="dhd_m"):
    """Streaming serving of a temporal preset (DHD-M, DHD-L): a bootstrap
    frame, then 5 frames through the cache with a cached pool plan."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.models import (DHDStereoNet, build_stream_cv_static,
                                      build_stream_pool_plan)

    cfg = get_config(preset)
    phase = PHASE_OF[preset]["stream"]
    path = f"{preset}_stream"
    bf16 = torch.bfloat16
    model = DHDStereoNet(cfg, dtype=bf16, device=dev,
                         generator=torch.Generator().manual_seed(0))
    frames = stream_frames(cfg, 6)
    plan = build_stream_pool_plan(cfg, frames[0], device=dev)
    static = build_stream_cv_static(cfg, frames[0], device=dev)
    frames = [dict(f, pool_plan=plan, cv_static=static) for f in frames]

    t0 = time.perf_counter()
    _, cache0 = model(frames[0], cache={})          # bootstrap frame
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t0)

    per_frame = stream_kernels(cfg)
    torch.cuda.reset_peak_memory_stats()
    for fn in per_frame:
        fn.launches = 0
    frame_ms, outs, cache = [], [], cache0
    for frame in frames[1:]:
        t0 = time.perf_counter()
        out, cache = model(frame, cache=cache)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        outs.append(out["occ_logits"])
    launches = {fn.__name__: fn.launches for fn in per_frame}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for fn, k in per_frame.items():
        kernels[fn.__name__].setdefault("launches_by_path", {})[path] = \
            fn.launches
        check(fn.launches == 5 * k, f"{fn.__name__} launched {fn.launches} "
              f"times in 5 frames, want {5 * k}")
    want = (1, cfg.vt.x.size, cfg.vt.y.size, cfg.head_Dz, cfg.num_classes)
    for occ in outs:
        check(tuple(occ.shape) == want, f"occ_logits {tuple(occ.shape)}")
        check(bool(torch.isfinite(occ).all()), "occ_logits not finite")
    check(rel_to_peak(outs[0], outs[1]) > 0, "frames gave equal outputs")

    plain = DHDStereoNet(
        dataclasses.replace(cfg, pool_method="xla", cv_method="xla",
                            attn_method="xla", ln_method="xla"),
        dtype=bf16, device=dev, generator=torch.Generator().manual_seed(0))
    plain.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    occ_p = plain(frames[1], cache=cache0)[0]["occ_logits"]
    torch.cuda.synchronize()
    plain_frame_ms = 1e3 * (time.perf_counter() - t0)
    rel = rel_to_peak(outs[0], occ_p)
    agree = float((outs[0].argmax(-1) == occ_p.argmax(-1)).float().mean())
    check(all(fn.launches == 5 * k for fn, k in per_frame.items()),
          f"plain path launched a kernel: "
          f"{ {fn.__name__: fn.launches for fn in per_frame} }")
    drift = (backbone_drift(model, plain, frames[1]["imgs"])
             if cfg.backbone == "swin_base" else [])
    frame = statistics.median(frame_ms)
    print(f"phase {phase} ok: {preset} bf16 streamed 5 frames after a "
          f"bootstrap, occ_logits {want}, finite; launches {launches}; "
          f"{frame:.2f} ms/frame median (frames "
          f"{', '.join(f'{t:.2f}' for t in frame_ms)}; bootstrap "
          f"{warm_ms:.1f} ms), peak memory {peak_gb:.2f} GB; every plain "
          f"version forced, same cache: rel-to-peak err {rel:.3e} (tol "
          f"{SERVE_REL_TOL}), argmax agreement {agree:.6f} (min "
          f"{SERVE_ARGMAX_MIN}), {plain_frame_ms:.2f} ms"
          + (f"; backbone outputs kernel vs plain, rel-to-peak "
             + ", ".join(f"{e:.3e}" for e in drift) if drift else "")
          + f"; on {card}", flush=True)
    check(rel <= SERVE_REL_TOL and agree >= SERVE_ARGMAX_MIN,
          f"kernel vs plain streaming: rel err {rel:.3e} (tol "
          f"{SERVE_REL_TOL}), argmax agreement {agree:.6f} (min "
          f"{SERVE_ARGMAX_MIN})")

    def step():
        return model(frames[1], cache=cache0)

    stages = stage_ms(model, step, extra=("_cost_volume",))
    busy, top, trace = device_busy_ms(step, n_top=10, model=model,
                                      ranges=("_cost_volume",))
    n_sync, sync_at = host_syncs(step)
    cv = trace.get("cost_volume", {})
    # the cost-volume stage of one frame planned from cv_static and
    # stepwise, three times each in turns
    stepwise = {k: v for k, v in frames[1].items() if k != "cv_static"}
    cv_ms = {"with": [], "without": []}
    for _ in range(3):
        for key, batch in (("with", frames[1]), ("without", stepwise)):
            cv_ms[key].append(stage_ms(
                model, lambda batch=batch: model(batch, cache=cache0),
                extra=("_cost_volume",))["cost_volume"])
    print(f"phase {phase} cv_static: cost_volume stage ms (CUDA events) "
          f"with cv_static {', '.join(f'{t:.3f}' for t in cv_ms['with'])}"
          f", stepwise plan "
          f"{', '.join(f'{t:.3f}' for t in cv_ms['without'])}; on {card}",
          flush=True)
    print(f"phase {phase} breakdown: host syncs per frame {n_sync} "
          f"({trace['frame']['syncs']} synchronize calls in the trace, "
          f"{trace['frame']['sync_host_ms']:.2f} ms) at {sync_at}; "
          f"cost_volume stage in the trace: host "
          f"{cv.get('host_ms', float('nan')):.3f} ms with "
          f"{cv.get('syncs', 0)} synchronize calls "
          f"({cv.get('sync_host_ms', 0.0):.3f} ms), device span "
          f"{cv.get('device_span_ms', float('nan')):.3f} ms holding "
          f"{cv.get('kernel_ms', float('nan')):.3f} ms of kernels; stage "
          "device ms (CUDA events) "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + (f"; device busy {busy:.2f} ms of {frame:.2f} ms/frame, idle "
             f"share {1 - busy / frame:.3f}; top kernels (ms) "
             + ", ".join(f"{n[:48]} {t:.3f}" for n, t in top)
             if busy > 0 else "; device busy: not measured (no device "
             "time in the profiler)"), flush=True)
    del model, plain
    torch.cuda.empty_cache()


def tiny_dhd_l():
    """A tiny DHD-L-shaped config (tests/test_torch_dhd_l.py): dhd_tiny_stereo
    at 64x192 with a Swin-B-shaped backbone (embed 16, depths (1, 1, 2, 1),
    heads (1, 2, 4, 8), window 4) and the FPN_LSS image neck."""
    from dhd_tpu_torch import get_config

    base = get_config("dhd_tiny_stereo")
    return dataclasses.replace(
        base, name="tiny_dhd_l",
        vt=dataclasses.replace(base.vt, input_size=(64, 192)),
        backbone="swin_base", swin_embed_dims=16, swin_depths=(1, 1, 2, 1),
        swin_num_heads=(1, 2, 4, 8), swin_window=4, img_neck="fpn_lss",
        img_neck_in_channels=(64, 128),
        img_neck_out_channels=base.vt.in_channels, sfa_in_channels=128)


def phase_small_stream(dev, cfg, phase):
    """A small temporal config in fp32: two streaming steps, GPU kernel
    path vs CPU plain path, same weights."""
    from dhd_tpu_torch.models import DHDStereoNet

    gpu = DHDStereoNet(cfg, device=dev,
                       generator=torch.Generator().manual_seed(3))
    cpu = DHDStereoNet(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    cache_g, cache_c, errs = {}, {}, {}
    for step, frame in enumerate(stream_frames(cfg, 2, seed=4)):
        out_g, cache_g = gpu(frame, cache=cache_g)
        out_c, cache_c = cpu(frame, cache=cache_c)
        for k in ("occ_logits", "depth", "height"):
            errs[f"{k}{step}"] = rel_to_peak(out_g[k].cpu(), out_c[k])
    check(all(e < TINY_REL_TOL for e in errs.values()),
          f"{cfg.name} GPU vs CPU: {errs} (tol {TINY_REL_TOL})")
    print(f"phase {phase} ok: {cfg.name} fp32 streaming, GPU vs CPU, "
          "rel-to-peak err "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
          + f" (tol {TINY_REL_TOL})", flush=True)


def segsum_cases():
    """B2's cases: (label, P, C, V, in dtype, out dtype, ids) with the
    ``--what pool`` shapes of DHD-S and DHD-L, P = N*D*fH*fW points of C
    channels into V = Dz*Dy*Dx voxels."""
    from dhd_tpu_torch import get_config

    bf16, f32 = torch.bfloat16, torch.float32
    shapes = {}
    for preset in ("dhd_s", "dhd_l"):
        vt = get_config(preset).vt
        fh, fw = vt.feat_size
        shapes[preset] = (get_config(preset).num_cams * vt.D * fh * fw,
                          vt.out_channels,
                          vt.z_fine.size * vt.y.size * vt.x.size)
    p, c, v = shapes["dhd_s"]
    return ([("dhd_s", *shapes["dhd_s"], bf16, bf16, "uniform"),
             ("dhd_l", *shapes["dhd_l"], bf16, bf16, "uniform"),
             ("dhd_s_fp32", p, c, v, f32, f32, "uniform"),
             ("dhd_s_hot", p, c, v, bf16, bf16, "hot"),
             ("dhd_s_negative", p, c, v, bf16, bf16, "negative")]
            + [(f"c{cc}", 65536, cc, 100000, bf16, bf16, "uniform")
               for cc in (8, 96, 160, 256)])


def segsum_ids(rng, p, v, layout):
    """Ids uniform over [0, 1.5 V); 'hot' puts 10% of the points on one
    id (tests/test_pallas_pool.py), 'negative' draws from [-V/4, 1.5 V)."""
    seg = rng.integers(0, int(SEGSUM_IDS * v), p)
    if layout == "hot":
        seg[: p // 10] = v // 2
    elif layout == "negative":
        seg = rng.integers(-v // 4, int(SEGSUM_IDS * v), p)
    return seg.astype(np.int32)


def library_segment_reduce(vals_s, seg_s, v):
    """The one PyTorch call that computes a sorted segment-sum:
    ``torch.segment_reduce`` with lengths, over the rows whose ids are in
    [0, V), in their own dtype."""
    lo, hi = (int(i) for i in torch.searchsorted(
        seg_s, torch.tensor([0, v], dtype=seg_s.dtype, device=seg_s.device)))
    rows = vals_s[lo:hi]
    lengths = torch.bincount(seg_s[lo:hi].long(), minlength=v)
    return lambda: torch.segment_reduce(rows, "sum", lengths=lengths,
                                        unsafe=True)


def phase_segment_sum(dev, kernels, ptxas):
    """B2 vs its plain version at the cases of :func:`segsum_cases`."""
    from dhd_tpu_torch.ops import (segment_sum_pooling, sorted_segment_sum,
                                   sorted_segment_sum_plain)

    kern = kernels["sorted_segment_sum"] = {
        "name": "sorted_segment_sum", "route": "cuda",
        "source": "dhd_tpu_torch/csrc/segment_sum.cu",
        "replaces": "dhd_tpu/ops/pallas_pool.py:48",
        "launches": None, "max_abs_err": 0.0, "shapes": {}}
    rng = np.random.default_rng(14)
    for label, p, c, v, dt, out_dt, layout in segsum_cases():
        vals = torch.from_numpy(rng.normal(0, 1, (p, c)).astype(
            np.float32)).to(dev, dt)
        seg = torch.from_numpy(segsum_ids(rng, p, v, layout)).to(dev)
        seg_s, order = torch.sort(seg, stable=True)
        order32 = order.to(torch.int32)
        vals_s = vals[order].contiguous()
        before = sorted_segment_sum.launches
        out_k = sorted_segment_sum(vals_s, seg_s, v, out_dt)
        torch.cuda.synchronize()
        check(sorted_segment_sum.launches == before + 1,
              "kernel launch not counted")
        out_p = sorted_segment_sum_plain(vals_s, seg_s, v, out_dt)
        terms = sorted_segment_sum_plain(vals_s.abs(), seg_s, v)
        err = float((out_k.float() - out_p.float()).abs().max())
        if out_dt == torch.bfloat16:
            share = sum_error_share(out_k, out_p, terms)
        else:
            diff = (out_k - out_p).abs()
            share = float(torch.where(diff > 0, diff / (TERM_TOL * terms),
                                      0.0).max())
        check(share <= 1, f"sorted_segment_sum {label}: error {share:.3f} of "
              f"its tolerance from plain (max abs {err:.3e})")
        keep = seg_s[(seg_s >= 0) & (seg_s < v)].long()
        empty = torch.bincount(keep, minlength=v) == 0
        check(bool((out_k[empty] == 0).all()),
              f"sorted_segment_sum {label}: an empty segment is not 0")
        same = None
        if out_dt == dt:
            same = torch.equal(segment_sum_pooling(vals, seg, v), out_k)
            check(same, f"segment_sum_pooling {label}: differs from the "
                  "sorted entry")

        lib = library_segment_reduce(vals_s, seg_s, v)
        ms = time_ms(lambda: sorted_segment_sum(vals_s, seg_s, v, out_dt))
        call_us = host_us(lambda: sorted_segment_sum(vals_s, seg_s, v,
                                                     out_dt))
        plain_ms = time_ms(lambda: sorted_segment_sum_plain(
            vals_s, seg_s, v, out_dt), iters=10, warmup=2)
        split = {
            "sort_ms": time_ms(lambda: torch.sort(seg, stable=True)),
            "gather_ms": time_ms(lambda: vals[order]),
            "kernel_gathering_ms": time_ms(lambda: sorted_segment_sum(
                vals, seg_s, v, out_dt, order=order32)),
            "entry_ms": time_ms(lambda: segment_sum_pooling(vals, seg, v))
            if out_dt == dt else None}
        # least time: the rows and ids in [0, V) read once (the sorted
        # dropped rows are never read), the output written once; one fp32
        # add per kept row element
        n_valid = keep.numel()
        nbytes = (n_valid * c * vals.element_size() + 4 * n_valid
                  + v * c * out_k.element_size())
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = n_valid * c / FP32_FLOP_PER_S
        hot = int(torch.bincount(keep, minlength=v).max())
        kern["shapes"][label] = measured = dict(
            {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "library_ms": time_ms(lib),
             "bound_ms": 1e3 * max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "P": p, "C": c, "V": v, "n_valid": n_valid,
             "busiest_segment": hot, "host_us": call_us}, **split)
        measured["bound_share"] = measured["bound_ms"] / ms
        kern["max_abs_err"] = max(kern["max_abs_err"], err)
        print(f"phase 14 ok: sorted_segment_sum vs plain at {label} "
              f"(P={p}, C={c}, V={v}, {str(dt)[6:]} -> {str(out_dt)[6:]}, "
              f"ids {layout}, {keep.numel()} in range, busiest segment "
              f"{hot}): max abs err {err:.3e}, {share:.3f} of the tolerance "
              f"({'1 bf16 ulp + ' if out_dt == torch.bfloat16 else ''}"
              f"2^-20 of the terms); empty segments 0 "
              f"({int(empty.sum())}); unsorted entry "
              f"{'bit-identical' if same else 'not compared'}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, segment_reduce "
              f"{measured['library_ms']:.4f} ms, bound "
              f"{measured['bound_ms']:.4f} ms ({measured['bound_by']}, "
              f"{nbytes / 1e6:.2f} MB; {measured['bound_share']:.3f} of the "
              f"kernel's time); least host time per call {call_us:.1f} us; "
              "unsorted entry "
              + (f"{split['entry_ms']:.4f} ms = " if split["entry_ms"]
                 else "")
              + f"sort {split['sort_ms']:.4f} + kernel gathering the rows "
              f"{split['kernel_gathering_ms']:.4f} ms (a separate row "
              f"gather would be {split['gather_ms']:.4f} ms)", flush=True)
        del vals, vals_s, out_k, out_p, terms
    kern.update({key: kern["shapes"]["dhd_s"][key]
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by")})
    # per instantiation <in, out, channels per lane>: registers, spills
    print("phase 14: ptxas <in, out, channels per lane>: " + "; ".join(
        f"{kind} " + ln for kind in ("share", "fixup")
        for ln in short_ptxas(ptxas.get("segment_sum", []),
                              f"segment_sum_{kind}_kernel")), flush=True)


def phase_cli(dev, kernels):
    """The benchmark CLI in-process on the card: each run's printed times
    must be finite, and the kernels of its path must launch."""
    from dhd_tpu_torch.cli.benchmark import main as benchmark
    from dhd_tpu_torch.ops import (mghs_pool_cuda, sorted_segment_sum,
                                   stereo_cost_volume_cuda)
    from dhd_tpu_torch.ops.mghs_pool_cuda import pool_plan_cuda

    runs = [("pool", "dhd_s", ["--iters", "10"]),
            ("pool", "dhd_l", ["--iters", "10"]),
            ("stream", "dhd_m", ["--iters", "5"]),
            ("cv", "dhd_l", ["--iters", "5"]),
            ("stages", "dhd_s", ["--iters", "5"]),
            ("flops", "dhd_s", []),
            ("full", "dhd_s", ["--iters", "5", "--profile",
                               "--profile-ops", "8"]),
            ("train", "dhd_s", ["--iters", "3", "--batch-size", "4",
                                "--profile-ops", "8"]),
            ("train", "dhd_s", ["--iters", "3", "--batch-size", "4",
                                "--pool-plan", "--profile-ops", "8"])]
    counted = (sorted_segment_sum, mghs_pool_cuda, pool_plan_cuda,
               stereo_cost_volume_cuda)
    # the path each run must go through, beyond finite times: pool, stages
    # and full plan in the call, with B1's plan kernels
    must = {"pool": (sorted_segment_sum, mghs_pool_cuda, pool_plan_cuda),
            "stream": (mghs_pool_cuda, stereo_cost_volume_cuda),
            "cv": (stereo_cost_volume_cuda,),
            "stages": (mghs_pool_cuda, pool_plan_cuda),
            "full": (mghs_pool_cuda, pool_plan_cuda), "flops": (),
            "train": (mghs_pool_cuda, pool_plan_cuda)}
    for what, preset, extra in runs:
        for fn in counted:
            fn.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = benchmark(["--preset", preset, "--what", what, *extra])
        wall = time.perf_counter() - t0
        text = out.getvalue()
        launches = {fn.__name__: fn.launches for fn in counted}
        times = [float(t) for t in re.findall(r"(\S+) ms\b", text)]
        check(rc == 0, f"cli --what {what} returned {rc}")
        check(what == "flops" or (times and all(
            np.isfinite(t) and t >= 0 for t in times)),
            f"cli --what {what} --preset {preset}: times {times}")
        if what == "flops":
            flops = re.search(r"forward flops: ([\d.]+) G", text)
            check(flops is not None and float(flops.group(1)) > 0,
                  f"cli --what flops: {text}")
        for fn in must[what]:
            check(fn.launches > 0, f"cli --what {what} --preset {preset}: "
                  f"{fn.__name__} never launched")
        if what == "stream":
            check("ship pool_plan and cv_static" in text,
                  "cli --what stream did not ship cv_static")
        if what == "train":
            losses = re.search(r"^losses: (.*)$", text, re.M)
            check(losses is not None and all(
                np.isfinite(float(kv.split("=")[1]))
                for kv in losses.group(1).split())
                and "device busy" in text and "peak memory: " in text
                and ("--pool-plan" not in extra
                     or "ships a precomputed pool plan" in text),
                f"cli --what train {' '.join(extra)}: {text}")
        if what == "pool":
            for fn in must["pool"]:
                kernels[fn.__name__].setdefault("launches_by_path", {})[
                    f"cli_pool_{preset}"] = fn.launches
        if what == "full":
            kernels["pool_plan_cuda"]["launches_by_path"][
                f"cli_full_{preset}"] = pool_plan_cuda.launches
        print(f"phase 15 ok: cli --preset {preset} --what {what} "
              f"{' '.join(extra)} in {wall:.1f} s; launches {launches}"
              + "".join(f"\n    {ln}" for ln in text.splitlines()),
              flush=True)
        torch.cuda.empty_cache()


@contextlib.contextmanager
def full_fp32():
    """cuDNN and cuBLAS in full fp32 inside (no TF32): the fp32 GPU-vs-CPU
    comparisons.  Outside, PyTorch's defaults hold (cuDNN TF32 on, matmul
    TF32 off), the mode a user trains in unless they set otherwise."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def tf32_mode() -> str:
    return (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
            f"cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}")


def train_setup(cfg, dev, seed: int = 0):
    """A model of ``cfg`` in fp32 on ``dev`` with seeded weights, its AdamW
    schedule, EMA and dropout generator, as ``cli/train`` builds them."""
    from dhd_tpu_torch.models import build_model
    from dhd_tpu_torch.train import AdamWSchedule, ModelEMA

    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(seed))
    return (model, AdamWSchedule(model.parameters(), cfg.optim, 1000),
            ModelEMA(model, cfg.optim.ema_init_updates, cfg.optim.ema_decay),
            torch.Generator(device=dev).manual_seed(seed + 1))


def on_device(batch: dict, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def stored_dtypes(model, opt, ema) -> set:
    """The dtypes of everything a training run keeps: params, gradients,
    AdamW's moments, the floating buffers (BN running statistics) and the
    EMA."""
    out = {p.dtype for p in model.parameters()}
    out |= {p.grad.dtype for p in model.parameters() if p.grad is not None}
    out |= {b.dtype for b in model.buffers() if b.is_floating_point()}
    out |= {t.dtype for st in opt.adamw.state.values()
            for t in (st["exp_avg"], st["exp_avg_sq"])}
    return out | {t.dtype for t in ema.shadow.values()}


def timed_train(cfg, dev, b, counted, compute_dtype=None,
                steps=TRAIN_STEPS):
    """``cfg`` trained at B=``b`` as ``cli/train`` trains it (the forward in
    ``compute_dtype``): one synthetic batch with GT from seed 0 on the
    device, TRAIN_WARMUP warm-up steps, then ``steps`` timed (host wall
    time to a synchronize) with the launches of the ``counted`` wrappers
    set to 0 just before and read just after.  Every loss must be finite
    and every stored tensor fp32.  Returns the run's state and readings."""
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.train import train_step

    batch = on_device(synthetic_batch(cfg, b, seed=0, with_gt=True), dev)
    model, opt, ema, gen = train_setup(cfg, dev)

    def one_step():
        return train_step(model, opt, ema, batch, gen,
                          compute_dtype=compute_dtype)
    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        one_step()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_ms, metrics = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = one_step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {fn.__name__: fn.launches for fn in counted}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(v) for m in metrics for v in m.values()),
          f"{cfg.name} train metrics not finite: {metrics}")
    want_updates = cfg.optim.ema_init_updates + TRAIN_WARMUP + steps
    check(ema.updates == want_updates and opt.count == TRAIN_WARMUP + steps,
          f"EMA counter {ema.updates}, want {want_updates}")
    kept = stored_dtypes(model, opt, ema)
    check(kept == {torch.float32}, f"{cfg.name} keeps {kept}, want fp32")
    return {"model": model, "opt": opt, "ema": ema, "gen": gen,
            "batch": batch, "one_step": one_step, "step_ms": step_ms,
            "metrics": metrics, "launches": launches, "peak_gb": peak_gb,
            "warm_s": warm_s, "n_params": sum(p.numel()
                                              for p in model.parameters())}


def train_line(run, b) -> str:
    """ms/step median, samples/s, the steps, warm-up and peak memory."""
    step = statistics.median(run["step_ms"])
    return (f"{step:.2f} ms/step median = {b / step * 1e3:.2f} samples/s "
            f"(steps {', '.join(f'{t:.2f}' for t in run['step_ms'])}; "
            f"{TRAIN_WARMUP} warm-up steps {run['warm_s']:.1f} s), peak "
            f"memory {run['peak_gb']:.2f} GB")


def phase_train(dev, kernels, card):
    """DHD-S training at full width: fp32, B=4, 6 cameras at 256x704,
    ResNet-50 with remat, HeightNet with DCN and ASPP (dropout 0.5 from a
    generator), synthetic data with GT from seed 0, on the device before
    timing.  2 warm-up steps, then 3 timed (host wall time to a
    synchronize); B1 and its plan kernels once a step; one traced step
    (trace_device) and one under the sync debug mode; then a checkpoint of
    the state after them, loaded into a new model, whose next step must
    give the live run's losses (the forward is deterministic; the
    backward's atomics are not, so its gradient norm is held to
    TRAIN_RESUME_TOL and its params to two learning rates).  Then the same
    training in bf16 mixed precision, 2 + 3 steps, with its traced step."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.io import load_checkpoint, save_checkpoint
    from dhd_tpu_torch.ops import mghs_pool_cuda
    from dhd_tpu_torch.ops.mghs_pool_cuda import pool_plan_cuda
    from dhd_tpu_torch.train import train_step

    cfg = get_config("dhd_s")
    b = 4
    counted = (mghs_pool_cuda, pool_plan_cuda)
    run = timed_train(cfg, dev, b, counted)
    model, opt, ema, gen, batch = (run[k] for k in ("model", "opt", "ema",
                                                    "gen", "batch"))
    launches, metrics = run["launches"], run["metrics"]
    for fn in counted:
        kernels[fn.__name__]["launches_by_path"]["train"] = fn.launches
        check(fn.launches == TRAIN_STEPS, f"{fn.__name__} launched "
              f"{fn.launches} times in {TRAIN_STEPS} train steps, want "
              f"{TRAIN_STEPS}")
    want_updates = cfg.optim.ema_init_updates + TRAIN_WARMUP + TRAIN_STEPS
    step = statistics.median(run["step_ms"])
    print(f"phase 16 ok: DHD-S fp32 train step, B={b}, "
          f"{run['n_params'] / 1e6:.1f} M params, remat, DCN, ASPP dropout "
          f"0.5 ({tf32_mode()}): {train_line(run, b)}; launches {launches}; "
          f"EMA counter {ema.updates}; last step "
          + " ".join(f"{k}={v:.5f}" for k, v in sorted(metrics[-1].items()))
          + f"; on {card}", flush=True)

    one_step = run["one_step"]
    del run
    busy, top, trace = device_busy_ms(one_step, n_top=10)
    n_sync, sync_at = host_syncs(one_step)
    # the forward of each top-level module by CUDA events ("frame": the
    # whole step, backward, clip, AdamW and EMA included)
    stages = stage_ms(model, one_step)
    print(f"phase 16 breakdown: device busy {busy:.2f} ms of {step:.2f} "
          f"ms/step, idle share {1 - busy / step:.3f}; host syncs per step "
          f"{n_sync} ({trace['frame']['syncs']} synchronize calls in the "
          f"trace) at {sync_at}; forward stage ms (CUDA events) "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + "; top kernels (ms) "
          + ", ".join(f"{n[:60]} {t:.3f}" for n, t in top), flush=True)

    # a checkpoint of the live state, a new model from it, one more step
    buf = io.BytesIO()
    t0 = time.perf_counter()
    save_checkpoint(buf, model, opt, ema, step=opt.count, generator=gen)
    save_s = time.perf_counter() - t0
    saved = {k: p.detach().clone() for k, p in model.named_parameters()}
    live = {k: float(v) for k, v in one_step().items()}
    live_avg = first_moments(model, opt)
    del model, opt, ema
    torch.cuda.empty_cache()
    model, opt, ema, gen = train_setup(cfg, dev, seed=123)
    t0 = time.perf_counter()
    count = load_checkpoint(buf, model, opt, ema, gen)
    load_s = time.perf_counter() - t0
    loaded = all(torch.equal(p, saved[k])
                 for k, p in model.named_parameters())
    del saved
    resumed = {k: float(v) for k, v in
               train_step(model, opt, ema, batch, gen).items()}
    bitwise = all(resumed[k] == v for k, v in live.items()
                  if k != "grad_norm")
    loss_err = max(abs(resumed[k] - v) / abs(v) for k, v in live.items()
                   if k != "grad_norm")
    norm_rel = abs(resumed["grad_norm"] - live["grad_norm"]) \
        / live["grad_norm"]
    # AdamW's first moment after the step, 0.9 of the saved one plus 0.1
    # of a gradient that differs by the backward's atomics
    got = first_moments(model, opt)
    avg_err = math.sqrt(
        sum(float((got[k] - v).double().square().sum())
            for k, v in live_avg.items())
        / sum(float(v.double().square().sum()) for v in live_avg.values()))
    del got, live_avg
    check(count == TRAIN_WARMUP + TRAIN_STEPS + 3 and loaded
          and ema.updates == want_updates + 4 and loss_err <= 1e-6
          and norm_rel <= TRAIN_RESUME_TOL and avg_err <= RESUME_MOMENT_TOL,
          f"resumed step differs: {resumed} vs {live}, params loaded "
          f"bit for bit {loaded}, exp_avg rel-L2 {avg_err}")
    print(f"phase 16 checkpoint: {buf.getbuffer().nbytes / 1e9:.2f} GB "
          f"saved in {save_s:.1f} s, loaded in {load_s:.1f} s into a new "
          f"model, its params bit for bit the saved ones; its next step "
          f"against the live run's: losses rel diff {loss_err:.2e} (tol "
          f"1e-6; bit for bit: {bitwise}), grad_norm rel diff "
          f"{norm_rel:.2e} (tol {TRAIN_RESUME_TOL}), AdamW's exp_avg "
          f"rel-L2 {avg_err:.2e} (tol {RESUME_MOMENT_TOL}): the backward's "
          f"atomics", flush=True)
    del buf

    # B1 and its plan kernels at this step's own fp32 B=4 inputs and keys
    calls = record_train_step(lambda: train_step(model, opt, ema, batch,
                                                 gen))
    del model, opt, ema
    torch.cuda.empty_cache()
    cases = pool_cases(cfg, calls)
    check(len(cases) == 1, f"B1 called {len(cases)} times in a train step")
    phase_plan(dev, kernels, "dhd_s_train",
               phase_kernel(dev, kernels, "dhd_s_train", case=cases[0]),
               keys=cases[0][5])
    del calls, cases
    torch.cuda.empty_cache()

    # the same training in bf16 mixed precision
    steps = TRAIN_STEPS_BF16
    run = timed_train(cfg, dev, b, counted, torch.bfloat16, steps)
    for fn in counted:
        kernels[fn.__name__]["launches_by_path"]["train_bf16"] = fn.launches
        check(fn.launches == steps, f"{fn.__name__} launched {fn.launches} "
              f"times in {steps} bf16 train steps, want {steps}")
    step = statistics.median(run["step_ms"])
    busy, top, _ = device_busy_ms(run["one_step"], n_top=6)
    print(f"phase 16 bf16 ok: DHD-S bf16 mixed-precision train step, B={b} "
          f"(fp32 params, gradients, moments, statistics and EMA): "
          f"{train_line(run, b)}; launches {run['launches']}; last step "
          + " ".join(f"{k}={v:.5f}" for k, v in
                     sorted(run["metrics"][-1].items()))
          + f"; device busy {busy:.2f} ms of {step:.2f} ms/step, idle share "
          f"{1 - busy / step:.3f}; top kernels (ms) "
          + ", ".join(f"{n[:60]} {t:.3f}" for n, t in top), flush=True)
    del run
    torch.cuda.empty_cache()


def swin_launches_per_step(cfg) -> dict:
    """B4's and B5's launches in one DHD-L train step with its history:
    the history frame's whole Swin (a window attention a block; a
    LayerNorm for the patch embedding, two a block, one a PatchMerging and
    one an output stage) and the extra stereo frame's stage 0 (the patch
    embedding and stage 0's blocks); the key frame takes the plain
    versions under autograd."""
    d = cfg.swin_depths
    return {"window_attention_cuda": sum(d) + d[0],
            "fused_layer_norm_cuda": (1 + 2 * sum(d) + len(d) - 1
                                      + len(cfg.swin_out_indices))
            + 1 + 2 * d[0]}


def phase_train_dhd_l(dev, kernels, card):
    """DHD-L training at full width: Swin-B at 512x1408 with block remat
    and DropPath 0.1, FPN_LSS, the stereo cost volume, one history frame
    and the extra stereo frame, B=2 (the reference's per-GPU batch),
    synthetic data with GT from seed 0 on the device, AdamW from step 0.
    In bf16 mixed precision, then in fp32 (at B=1 if B=2 runs out of
    memory): 2 warm-up and 3 timed steps each; B1, its plan kernels and
    B3 twice a step (history and key frame), B4 and B5 in the history and
    extra frames (``swin_launches_per_step``); every loss finite; params,
    gradients, moments, statistics and EMA fp32; each BatchNorm steps
    its running statistics once per frame it runs in (the image neck
    twice a step, the BEV encoder once); one traced step's device busy
    time, idle share and top kernels, its host syncs and forward stage
    ms; then every kernel held against its plain version at the inputs
    one more step gives it (:func:`record_train_step`), timed under
    ``shapes`` as ``dhd_l_train_<precision>_<frame or shape>``."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.ops import (fused_layer_norm_cuda, mghs_pool_cuda,
                                   stereo_cost_volume_cuda,
                                   window_attention_cuda)
    from dhd_tpu_torch.ops.mghs_pool_cuda import pool_plan_cuda

    cfg = get_config("dhd_l")
    counted = (mghs_pool_cuda, pool_plan_cuda, stereo_cost_volume_cuda,
               window_attention_cuda, fused_layer_norm_cuda)
    per_step = {"mghs_pool_cuda": 2, "pool_plan_cuda": 2,
                "stereo_cost_volume_cuda": 2, **swin_launches_per_step(cfg)}
    steps = TRAIN_STEPS_DHD_L
    for name, dt, b in (("bf16", torch.bfloat16, 2), ("fp32", None, 2)):
        try:
            run = timed_train(cfg, dev, b, counted, dt, steps)
        except torch.cuda.OutOfMemoryError as e:
            check(b == 2 and dt is None, f"DHD-L {name} B={b}: {e}")
            torch.cuda.empty_cache()
            print(f"phase 18: DHD-L fp32 at B=2 does not fit on the card "
                  f"({str(e).splitlines()[0]}); fp32 at B=1", flush=True)
            b = 1
            run = timed_train(cfg, dev, b, counted, dt, steps)
        launches = run["launches"]
        for fn in counted:
            kernels[fn.__name__]["launches_by_path"][
                f"train_dhd_l_{name}"] = fn.launches
        check(launches == {k: v * steps for k, v in per_step.items()},
              f"DHD-L {name} launches {launches} in {steps} steps, want "
              f"{per_step} a step")
        model = run["model"]
        tracked = {k: int(v) for k, v in model.state_dict().items()
                   if k.endswith("num_batches_tracked")}
        total = TRAIN_WARMUP + steps
        check(tracked["img_neck.conv.1.num_batches_tracked"] == 2 * total
              and tracked["img_bev_encoder_neck.conv.1.num_batches_tracked"]
              == total and set(tracked.values()) <= {total, 2 * total},
              f"DHD-L {name} BatchNorm steps {tracked} after {total} steps")
        step = statistics.median(run["step_ms"])
        one_step = run["one_step"]
        busy, top, trace = device_busy_ms(one_step, n_top=10)
        n_sync, sync_at = host_syncs(one_step)
        stages = stage_ms(model, one_step)
        print(f"phase 18 ok: DHD-L {name} train step"
              + (" (bf16 mixed precision: fp32 params, gradients, moments, "
                 "statistics and EMA)" if dt else "")
              + f", B={b}, {run['n_params'] / 1e6:.1f} M params, Swin-B "
              f"remat, DropPath 0.1, one history frame ({tf32_mode()}): "
              f"{train_line(run, b)}; launches a step "
              f"{ {k: v // steps for k, v in launches.items()} }; last step "
              + " ".join(f"{k}={v:.5f}" for k, v in
                         sorted(run["metrics"][-1].items()))
              + f"; on {card}", flush=True)
        print(f"phase 18 {name} breakdown: device busy {busy:.2f} ms of "
              f"{step:.2f} ms/step, idle share {1 - busy / step:.3f}; host "
              f"syncs per step {n_sync} ({trace['frame']['syncs']} "
              f"synchronize calls in the trace) at {sync_at}; forward stage "
              f"ms (CUDA events) "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + "; top kernels (ms) "
              + ", ".join(f"{n[:60]} {t:.3f}" for n, t in top), flush=True)

        # every kernel of the step against its plain version at the
        # inputs this step gives it: B1, its plan and B3 in the history
        # and the key frame; B4 and B5 at each of their calls
        swin = {}
        calls = record_train_step(one_step, swin_holds(swin))
        del run, model, one_step
        torch.cuda.empty_cache()
        prefix = f"dhd_l_train_{name}_"
        cases = pool_cases(cfg, calls)
        check(len(cases) == 2 and len(calls["stereo_cost_volume_cuda"]) == 2
              and {k: sum(r["calls"] for r in rows.values())
                   for k, rows in swin.items()}
              == swin_launches_per_step(cfg),
              f"DHD-L {name}: a step's calls B1 {len(cases)}, B3 "
              f"{len(calls['stereo_cost_volume_cuda'])}, B4/B5 "
              f"{ {k: len(v) for k, v in swin.items()} } shapes")
        for frame, case, (args, _) in zip(
                ("history", "key"), cases, calls["stereo_cost_volume_cuda"]):
            phase_plan(dev, kernels, prefix + frame,
                       phase_kernel(dev, kernels, prefix + frame, case=case),
                       keys=case[5])
            phase_cost_volume(dev, kernels, prefix + frame, case=args)
        del calls, cases
        hold_swin_calls(kernels, prefix, swin)
        del swin
        torch.cuda.empty_cache()


def first_moments(model, opt) -> dict:
    """AdamW's exp_avg of every parameter, cloned, by name."""
    names = {p: k for k, p in model.named_parameters()}
    return {names[p]: st["exp_avg"].clone()
            for p, st in opt.adamw.state.items()}


# the kernel wrappers of the training path, by the module that calls them
TRAIN_CALLS = (("dhd_tpu_torch.models.dhd", "build_pool_plan"),
               ("dhd_tpu_torch.models.dhd", "mghs_pool_cuda"),
               ("dhd_tpu_torch.ops.cost_volume", "stereo_cost_volume_cuda"),
               ("dhd_tpu_torch.nn.swin", "window_attention_cuda"),
               ("dhd_tpu_torch.nn.swin", "fused_layer_norm_cuda"))


def record_train_step(step, inline=None) -> dict:
    """Runs ``step()`` (one train step) with each function of TRAIN_CALLS
    replaced, in the module that calls it, by one that calls it and keeps
    a copy of its arguments (B1's plan, ``build_pool_plan``'s, is kept as
    it is, with its result); where ``inline`` names the function,
    ``inline[name](args, result)`` is called instead.  Returns the kept
    calls by name, in their order."""
    import importlib

    calls = {name: [] for _, name in TRAIN_CALLS}

    def keep(a):
        return a.detach().clone() if torch.is_tensor(a) else a

    def recorded(name, real):
        def call(*args):
            out = real(*args)
            if inline and name in inline:
                inline[name](args, out)
            else:
                calls[name].append((tuple(keep(a) for a in args),
                                    out if name == "build_pool_plan"
                                    else None))
            return out
        return call
    saved = []
    for mod_name, name in TRAIN_CALLS:
        mod = importlib.import_module(mod_name)
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, recorded(name, getattr(mod, name)))
    try:
        step()
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
    return calls


def pool_cases(cfg, calls) -> list:
    """B1's recorded calls (:func:`record_train_step`) as :func:`phase_kernel`
    takes them: (cfg, plan, depth, feat, band_mask, (vt, PoolIndices, cams
    shape)), the keys those of the ``build_pool_plan`` call that made the
    plan."""
    keys = {id(plan): (vt, idx, shape)
            for (idx, vt, shape), plan in calls["build_pool_plan"]}
    return [(cfg, plan, depth, feat, band_mask, keys[id(plan)])
            for (depth, feat, band_mask, plan), _ in calls["mghs_pool_cuda"]]


def swin_holds(counts: dict):
    """``inline`` functions for :func:`record_train_step` that hold B4 and
    B5 against their plain versions at every call of the step, on the
    spot (a DHD-L step makes 85 of them, whose inputs would take GBs):
    B4 bf16 within ATTN_ULP_TOL bf16 ulps of the output's peak, fp32
    within ATTN_F32_TOL (atol and rtol); B5 within one bf16 ulp (fp32:
    LN_F32_ATOL) plus 2^-20 of the terms (:func:`ln_error`).  ``counts``
    gathers, per kernel and shape label, the calls, the worst share of
    the bar, the largest abs error and the first call's arguments (for
    the timings)."""
    from dhd_tpu_torch.ops import layer_norm_plain, window_attention_plain

    def note(kernel, label, args, err, share):
        row = counts.setdefault(kernel, {}).setdefault(
            label, {"calls": 0, "share": 0.0, "max_abs_err": 0.0,
                    "args": tuple(a.detach().clone() if torch.is_tensor(a)
                                  else a for a in args)})
        row["calls"] += 1
        row["share"] = max(row["share"], share)
        row["max_abs_err"] = max(row["max_abs_err"], err)

    def attention(args, out_k):
        qkv, bias, mask, heads = args
        out_p = window_attention_plain(qkv, bias, mask, heads)
        d = (out_k.float() - out_p.float()).abs()
        if qkv.dtype == torch.bfloat16:
            share = float(d.max()) / (ATTN_ULP_TOL * bf16_ulp_at(out_p))
        else:
            share = float((d / (ATTN_F32_TOL * (1 + out_p.abs()))).max())
        label = (f"c{qkv.shape[2] // 3}_"
                 f"{'unshifted' if mask is None else 'shifted'}")
        note("window_attention_cuda", label, args, float(d.max()), share)

    def layer_norm(args, y_k):
        x, w, b, eps = args
        y_p = layer_norm_plain(x, w, b, eps)
        _, share = ln_error(y_k, y_p, x, w, b, eps)
        c = x.shape[-1]
        note("fused_layer_norm_cuda", f"{x.numel() // c}x{c}", args,
             float((y_k.float() - y_p.float()).abs().max()), share)
    return {"window_attention_cuda": attention,
            "fused_layer_norm_cuda": layer_norm}


def hold_swin_calls(kernels, prefix, counts) -> None:
    """B4's and B5's readings from :func:`swin_holds`: every call within its
    bar (printed first, then checked), and each shape's first call timed
    with its plain version and the library call under ``shapes`` as
    ``prefix + label`` (:func:`time_kernel_and_plain`)."""
    from dhd_tpu_torch.ops import (fused_layer_norm_cuda, layer_norm_plain,
                                   window_attention_cuda,
                                   window_attention_plain)

    for name, rows in counts.items():
        kern = kernels[name]
        for label, row in rows.items():
            args = row["args"]
            x = args[0]
            rate = (BF16_FLOP_PER_S if x.dtype == torch.bfloat16
                    else FP32_FLOP_PER_S)
            if name == "window_attention_cuda":
                qkv, bias, mask, heads = args
                w, n, c3 = qkv.shape
                n_img = 1 if mask is None else mask.shape[0]
                nbytes = qkv.element_size() * (
                    qkv.numel() + w * n * c3 // 3 + bias.numel()
                    + (mask.numel() if mask is not None else 0))
                m = time_kernel_and_plain(
                    kern, prefix + label,
                    lambda: window_attention_cuda(*args),
                    lambda: window_attention_plain(*args),
                    attention_library(qkv, bias, mask, heads, n_img),
                    nbytes, w * heads * 4 * n * n * (c3 // 3 // heads),
                    rate, row["max_abs_err"], row["calls"])
                library = "SDPA"
            else:
                x, wt, b, eps = args
                c = x.shape[-1]
                w16, b16 = wt.to(x.dtype), b.to(x.dtype)
                m = time_kernel_and_plain(
                    kern, prefix + label,
                    lambda: fused_layer_norm_cuda(*args),
                    lambda: layer_norm_plain(*args),
                    lambda: torch.nn.functional.layer_norm(
                        x, (c,), w16, b16, eps),
                    2 * x.element_size() * x.numel() + 2 * 4 * c,
                    LN_FLOPS * x.numel(), FP32_FLOP_PER_S,
                    row["max_abs_err"], row["calls"])
                library = "F.layer_norm"
            m["bar_share"] = row["share"]
            print(f"phase 18: {name} vs plain at {prefix}{label} "
                  f"({tuple(x.shape)} {str(x.dtype)[6:]}), {row['calls']} "
                  f"calls a step, each held: worst {row['share']:.3f} of "
                  f"the bar, max abs err {row['max_abs_err']:.3e}; "
                  f"{timing_line(m, library)})", flush=True)
    for name, rows in counts.items():
        bad = {k: r["share"] for k, r in rows.items() if r["share"] > 1}
        check(not bad, f"{name} differs from plain beyond its bar at "
              f"{prefix}: {bad}")


def adamw_update_error(cfg, before: dict, after: dict, moments: dict,
                       lr: float) -> float:
    """The largest distance, in learning rates, of AdamW's first step from
    zero moments (params ``before`` -> ``after``, dicts by name) from the
    formula on its own moments: p (1 - lr wd) - lr m^ / (sqrt(v^) + eps),
    m^ = m / (1 - b1), v^ = v / (1 - b2); each element's own fp32
    rounding, 2^-22 of |p|, aside."""
    worst = 0.0
    for k, p0 in before.items():
        p0, m, v = (t.double() for t in (p0, moments["exp_avg"][k],
                                          moments["exp_avg_sq"][k]))
        want = p0 * (1 - lr * cfg.optim.weight_decay) - lr * (m / 0.1) / (
            (v / 1e-3).sqrt() + 1e-8)
        err = (after[k].double() - want).abs() - 2.0 ** -22 * p0.abs()
        worst = max(worst, float(err.max()) / lr)
    return worst


def phase_train_small(dev):
    """dhd_tiny (ASPP dropout off), dhd_micro_stereo (F frames, B3 in the
    forward) and the tiny DHD-L-shaped config (Swin with block remat and
    DropPath at 0; B4 and B5 in its history frames) in fp32 without TF32:
    one train step at the full learning rate (the schedule past its
    warmup) on the GPU and on the CPU from the same weights and batch.  The losses within
    TRAIN_LOSS_RTOL; the gradients and AdamW's first moment within
    GRAD_TOLS (rel-L2 of the whole, the median and the worst tensor:
    flipped ReLU gates move single tensors, ``train/compare.py``), the
    second moment within SQ_TOLS; the GPU's update within UPDATE_LR_TOL
    learning rates of AdamW's formula on its own moments.  A control, the
    CPU's step again on images one part in 2^22 larger, reads how far
    fp32 rounding alone moves the same numbers."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.nn.swin import DropPath
    from dhd_tpu_torch.ops import (fused_layer_norm_cuda, mghs_pool_cuda,
                                   stereo_cost_volume_cuda,
                                   window_attention_cuda)
    from dhd_tpu_torch.train import (gradient_errors, train_step,
                                     zero_gradient_params)

    cpu = torch.device("cpu")
    tols = {"grad": GRAD_TOLS, "exp_avg": GRAD_TOLS, "exp_avg_sq": SQ_TOLS}
    counted = (mghs_pool_cuda, stereo_cost_volume_cuda,
               window_attention_cuda, fused_layer_norm_cuda)
    for name in ("dhd_tiny", "dhd_micro_stereo", "tiny_dhd_l"):
        cfg = tiny_dhd_l() if name == "tiny_dhd_l" else get_config(name)
        cfg = dataclasses.replace(
            cfg, heightnet_cfg=dataclasses.replace(cfg.heightnet_cfg,
                                                   aspp_dropout=0.0),
            depthnet_cfg=dataclasses.replace(cfg.depthnet_cfg,
                                             aspp_dropout=0.0))
        batch = synthetic_batch(cfg, 2, seed=5, varied_rig=True)
        runs, weights = {}, None
        before = [fn.launches for fn in counted]
        for side, where, scale in (("gpu", dev, 1.0), ("cpu", cpu, 1.0),
                                   ("control", cpu, 1.0 + 2.0 ** -22)):
            model, opt, ema, _ = train_setup(cfg, where, seed=7)
            for m in model.modules():
                if isinstance(m, DropPath):
                    m.rate = 0.0
            if weights is None:
                weights = {k: v.cpu().clone()
                           for k, v in model.state_dict().items()}
            else:
                model.load_state_dict(weights)
            init = {k: p.detach().cpu().clone()
                    for k, p in model.named_parameters()}
            opt.count = cfg.optim.warmup_iters      # the full rate from here
            lr = opt.schedule(opt.count)
            imgs = batch["imgs"] * np.float32(scale)
            m = train_step(model, opt, ema, on_device(dict(batch, imgs=imgs),
                                                      where))
            names = {p: k for k, p in model.named_parameters()}
            run = {"metrics": {k: float(v) for k, v in m.items()},
                   "grad": {k: p.grad.cpu().clone()
                            for k, p in model.named_parameters()},
                   "params": {k: p.detach().cpu().clone()
                              for k, p in model.named_parameters()}}
            for key in ("exp_avg", "exp_avg_sq"):
                run[key] = {names[p]: st[key].cpu().clone()
                            for p, st in opt.adamw.state.items()}
            runs[side] = run
            if side == "gpu":
                kernel_runs = tuple(fn.launches - n
                                    for fn, n in zip(counted, before))
                update_err = adamw_update_error(cfg, init, run["params"],
                                                run, lr)
        zero = zero_gradient_params(model)
        mg, mc = runs["gpu"]["metrics"], runs["cpu"]["metrics"]
        loss_err = max(abs(mg[k] - v) / abs(v) for k, v in mc.items()
                       if k != "grad_norm")
        read = {key: gradient_errors(runs["gpu"][key], runs["cpu"][key],
                                     zero) for key in tols}
        control = {key: gradient_errors(runs["control"][key],
                                        runs["cpu"][key], zero)
                   for key in tols}
        bad = [key for key, tol in tols.items()
               if any(r > t for r, t in zip(read[key], tol))]
        swin = (tuple(swin_launches_per_step(cfg).values())
                if cfg.backbone == "swin_base" else (0, 0))
        check(loss_err <= TRAIN_LOSS_RTOL and not bad
              and update_err <= UPDATE_LR_TOL
              and kernel_runs[0] == (2 if cfg.temporal else 1)
              and (kernel_runs[1] > 0) == cfg.stereo
              and kernel_runs[2:] == swin,
              f"{name} train step GPU vs CPU: losses {loss_err:.2e}, "
              f"{read} beyond {bad}, update {update_err:.2e} lr, B1/B3/B4/B5 "
              f"launches {kernel_runs}, want B4/B5 {swin}")

        def fmt(r):
            return "/".join(f"{x:.2e}" for x in r)
        print(f"phase 17 ok: {name} fp32 train step at lr {lr:.1e}, GPU vs "
              f"CPU ({tf32_mode()}): losses rel err {loss_err:.2e} (tol "
              f"{TRAIN_LOSS_RTOL}), grad_norm {mg['grad_norm']:.5f} vs "
              f"{mc['grad_norm']:.5f}; rel-L2 whole/median tensor/worst "
              f"tensor (tol; control, CPU on images x (1 + 2^-22)): "
              + ", ".join(f"{key} {fmt(read[key])} ({fmt(tols[key])}; "
                          f"{fmt(control[key])})" for key in tols)
              + f"; the GPU's update off AdamW's formula by {update_err:.2e}"
              f" lr (tol {UPDATE_LR_TOL}); B1, B3, B4, B5 launches on the "
              f"GPU {kernel_runs}", flush=True)


def eval_launches_per_sample(cfg) -> dict:
    """The kernels one sample's eval forward launches (the F-frame forward
    of a temporal preset, plans built in the call): B1 and its plan kernels
    once per frame through the whole model, B3 as often in a stereo
    model, and with a Swin backbone B4 once per block and B5 for the patch
    embedding, two per block, each PatchMerging and each output norm in
    those frames, plus the extra stereo frame's stage 0."""
    full = cfg.num_frames - (1 if cfg.stereo else 0)
    out = {"mghs_pool_cuda": full, "pool_plan_cuda": full}
    if cfg.stereo:
        out["stereo_cost_volume_cuda"] = full
    if cfg.backbone == "swin_base":
        d = cfg.swin_depths
        extra = d[0] if cfg.stereo else 0       # the extra frame's blocks
        out["window_attention_cuda"] = full * sum(d) + extra
        out["fused_layer_norm_cuda"] = (
            full * (1 + 2 * sum(d) + len(d) - 1 + len(cfg.swin_out_indices))
            + (1 + 2 * extra if cfg.stereo else 0))
    return out


def eval_counters():
    """The wrappers whose launches an eval forward can count, by name."""
    from dhd_tpu_torch.ops import (fused_layer_norm_cuda, mghs_pool_cuda,
                                   stereo_cost_volume_cuda,
                                   window_attention_cuda)
    from dhd_tpu_torch.ops.mghs_pool_cuda import pool_plan_cuda
    return {fn.__name__: fn for fn in (
        mghs_pool_cuda, pool_plan_cuda, stereo_cost_volume_cuda,
        window_attention_cuda, fused_layer_norm_cuda)}


@contextlib.contextmanager
def recording_metric():
    """Inside, ``MIoUMetric.add_batch`` keeps the metric it counts into and
    a host copy of every prediction grid it is given."""
    from dhd_tpu_torch.eval import MIoUMetric

    seen = {"metric": None, "preds": []}
    add = MIoUMetric.add_batch

    def record(self, pred, gt, mask):
        seen["metric"] = self
        seen["preds"].extend(torch.as_tensor(pred).cpu().numpy())
        return add(self, pred, gt, mask)

    MIoUMetric.add_batch = record
    try:
        yield seen
    finally:
        MIoUMetric.add_batch = add


def run_cli(main_fn, argv, counted=()):
    """A CLI's ``main(argv)`` in-process with the ``counted`` wrappers'
    launches set to 0 before it: (return code, printed text, launches,
    wall s)."""
    for fn in counted:
        fn.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    wall = time.perf_counter() - t0
    return rc, out.getvalue(), {fn.__name__: fn.launches for fn in counted}, \
        wall


def run_eval_cli(argv, counted):
    """``cli/test``'s main in-process with every count set to 0 before it:
    (return code, printed text, launches, wall s, peak GB, recorded)."""
    from dhd_tpu_torch.cli.test import main as evaluate

    torch.cuda.reset_peak_memory_stats()
    with recording_metric() as seen:
        rc, text, launches, wall = run_cli(evaluate, argv, counted)
    return (rc, text, launches, wall,
            torch.cuda.max_memory_allocated() / 1e9, seen)


def eval_ms_per_sample(model, batches, n: int = EVAL_TIMED):
    """Host wall time of one sample's eval step as ``cli/test`` runs it
    (forward under inference_mode, argmax and confusion matrix on the
    device, the 18x18 copy to the host): median of ``n`` after a warm-up,
    and its spread."""
    from dhd_tpu_torch.eval import MIoUMetric

    metric = MIoUMetric()

    def step(batch):
        with torch.inference_mode():
            occ = model(batch)["occ_logits"].argmax(-1).to(torch.uint8)
            metric.add_batch(occ, batch["voxel_semantics"],
                             batch["mask_camera"])
        return occ

    step(batches[0])
    ms = []
    for k in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batches[k % len(batches)])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ms), min(ms), max(ms)


def plain_agreement(cfg, dtype, dev, model, batches, preds):
    """Share of voxels where the plain path (every kernel's plain version,
    the same weights) predicts the class in ``preds`` (one grid per
    sample, in batch order)."""
    from dhd_tpu_torch.models import build_model

    plain = build_model(dataclasses.replace(
        cfg, pool_method="xla", cv_method="xla", attn_method="xla",
        ln_method="xla"), dtype=dtype, device=dev)
    if model is not None:
        plain.load_state_dict(model.state_dict())
    same = []
    with torch.inference_mode():
        for batch, pred in zip(batches, preds):
            occ = plain(batch)["occ_logits"].argmax(-1).cpu().numpy()[0]
            same.append(float((occ == pred).mean()))
    del plain
    return float(np.mean(same))


def phase_eval(dev, kernels, card, preset="dhd_s"):
    """``cli/test --synthetic`` at full width (B=1, 2 batches), fp32 and
    ``--bf16``: B1 and its plan kernels once a batch; the predictions
    within EVAL_ARGMAX_MIN of the plain path's; the card's confusion
    matrix equal to a float64 numpy count of the same grids; ms per
    sample of the eval step and the run's peak memory."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.models import build_model

    cfg = get_config(preset)
    want = {k: 2 * v for k, v in eval_launches_per_sample(cfg).items()}
    counted = [fn for name, fn in eval_counters().items() if name in want]
    batches = [synthetic_batch(cfg, batch_size=1, seed=i) for i in range(2)]
    for name, flags, dtype in (("fp32", [], torch.float32),
                               ("bf16", ["--bf16"], torch.bfloat16)):
        rc, text, launches, wall, peak_gb, seen = run_eval_cli(
            ["--preset", preset, "--synthetic", *flags], counted)
        check(rc == 0 and "evaluated 2 samples" in text
              and "===> mIoU: " in text, f"cli/test {preset} {name}: {text}")
        check(launches == want, f"cli/test {preset} {name}: launches "
              f"{launches}, want {want} in 2 batches")
        for fn in counted:
            kernels[fn.__name__]["launches_by_path"][
                f"eval_{preset}_{name}"] = fn.launches
        preds = seen["preds"]
        cm = np.zeros((cfg.num_classes,) * 2, np.float64)
        for pred, b in zip(preds, batches):
            m = b["mask_camera"][0] != 0
            np.add.at(cm, (b["voxel_semantics"][0][m].astype(np.int64),
                           pred[m].astype(np.int64)), 1.0)
        check(len(preds) == 2 and np.array_equal(seen["metric"].cm, cm),
              f"cli/test {preset} {name}: the card's confusion matrix "
              f"differs from numpy's float64 count")
        model = build_model(cfg, dtype=dtype, device=dev)
        ms, lo, hi = eval_ms_per_sample(model, batches)
        agree = plain_agreement(cfg, dtype, dev, model, batches, preds)
        check(agree >= SERVE_ARGMAX_MIN,
              f"cli/test {preset} {name}: {agree:.6f} of voxels agree with "
              f"the plain path (min {SERVE_ARGMAX_MIN})")
        print(f"phase 19 ok: cli/test --preset {preset} --synthetic "
              f"{' '.join(flags)} (B=1, 2 batches, {cfg.vt.input_size}) in "
              f"{wall:.1f} s: launches {launches}; confusion matrix (int64 "
              f"bincount on the card) equal to numpy's float64 count of "
              f"{int(cm.sum())} voxels; {agree:.6f} of voxels with the plain "
              f"path's class (min {SERVE_ARGMAX_MIN}); eval step "
              f"{ms:.2f} ms/sample median of {EVAL_TIMED} ({lo:.2f}-"
              f"{hi:.2f}); peak memory {peak_gb:.2f} GB; on {card}"
              + "".join(f"\n    {ln}" for ln in text.splitlines()[-2:]),
              flush=True)
        del model
        torch.cuda.empty_cache()


def phase_eval_dhd_l(dev, kernels, card, preset="dhd_l"):
    """DHD-L's eval forward at full width (Swin-B at 512x1408), bf16, B=1:
    the history and extra stereo frames and the alignment after the view
    transformation on, as ``cli/test`` sets it for temporal presets; each
    kernel's launches per sample exact; the predictions within
    EVAL_ARGMAX_MIN of the plain path's; ms per sample, peak memory."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.models import build_model

    cfg = dataclasses.replace(get_config(preset),
                              align_after_view_transformation=True)
    bf16 = torch.bfloat16
    per = eval_launches_per_sample(cfg)
    counted = [fn for name, fn in eval_counters().items() if name in per]
    model = build_model(cfg, dtype=bf16, device=dev)
    batches = [synthetic_batch(cfg, batch_size=1, seed=i) for i in range(2)]
    n = EVAL_TIMED
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ms, lo, hi = eval_ms_per_sample(model, batches, n)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {fn.__name__: fn.launches for fn in counted}
    want = {k: (n + 1) * v for k, v in per.items()}
    check(launches == want, f"{preset} eval: launches {launches} in "
          f"{n + 1} samples, want {per} a sample")
    for fn in counted:
        kernels[fn.__name__]["launches_by_path"][f"eval_{preset}_bf16"] = \
            fn.launches
    with torch.inference_mode():
        preds = [model(b)["occ_logits"].argmax(-1).cpu().numpy()[0]
                 for b in batches]
    agree = plain_agreement(cfg, bf16, dev, model, batches, preds)
    check(agree >= SERVE_ARGMAX_MIN,
          f"{preset} eval: {agree:.6f} of voxels agree with the plain path "
          f"(min {SERVE_ARGMAX_MIN})")
    print(f"phase 20 ok: {preset} eval forward, bf16, B=1, "
          f"{cfg.vt.input_size}, {cfg.num_frames} frames (history and extra "
          f"stereo frame), aligned after the view transformation: launches "
          f"a sample { {k: v // (n + 1) for k, v in launches.items()} }; "
          f"{agree:.6f} of voxels with the plain path's class (min "
          f"{SERVE_ARGMAX_MIN}); eval step {ms:.2f} ms/sample median of {n} "
          f"({lo:.2f}-{hi:.2f}); peak memory {peak_gb:.2f} GB; on {card}",
          flush=True)
    del model
    torch.cuda.empty_cache()


def scene_infos(n: int = 12):
    """One synthetic nuScenes scene: the ego drives 4 m a sample along a
    gentle curve, nuScenes' lidar mount (0.94 m ahead, 1.84 m up)."""
    infos = []
    for i in range(n):
        yaw = 0.02 * i
        infos.append({
            "token": f"tok{i}", "scene_token": "scene0",
            "ego2global_rotation": [math.cos(yaw / 2), 0.0, 0.0,
                                    math.sin(yaw / 2)],
            "ego2global_translation": [411.3 + 4.0 * i, 1180.6 + 0.4 * i * i
                                       / 10, 0.0],
            "lidar2ego_rotation": [0.7071, 0.0, 0.0, 0.7071],
            "lidar2ego_translation": [0.94, 0.0, 1.84]})
    return infos


def occupancy_scene(seed: int = 0, shape=(200, 200, 16)):
    """A (200, 200, 16) class grid like Occ3D's: drivable ground and
    sidewalk slabs, buildings and vegetation at the edges, cars and other
    objects on the road, free above; and a prediction of it with 5% of
    the occupied voxels of another class and 2% of the free ones filled."""
    rng = np.random.default_rng(seed)
    free = 17
    gt = np.full(shape, free, np.uint8)
    gt[:, :, :2] = 11
    gt[:, 130:, :3] = 13
    gt[:, 170:, :12] = 15
    gt[:25, :, :9] = 16
    for _ in range(60):
        x, y = rng.integers(20, 180, 2)
        w, l, h = rng.integers(2, 6), rng.integers(4, 12), rng.integers(3, 6)
        gt[x:x + w, y:y + l, 2:2 + h] = rng.integers(1, 11)
    pred = gt.copy()
    occ = gt != free
    flip = occ & (rng.random(shape) < 0.05)
    pred[flip] = rng.integers(0, 17, int(flip.sum()))
    fill = ~occ & (rng.random(shape) < 0.02)
    pred[fill] = rng.integers(0, 17, int(fill.sum()))
    return pred, gt


def phase_rayiou(dev, card, shape=(200, 200, 16)):
    """RayIoU at Occ3D's 200x200x16: the 14,040-ray fan from the origins
    ``scene_origins`` derives from a synthetic scene (8, the most it
    takes), prediction and GT marched in one call; the card against the
    CPU (the RayIoU keys within RAYIOU_TOL, at most RAY_MOVED_MAX of the
    rays at another voxel), ms per sample on both; then ``dvr.render``
    over a density grid of the same scene, card against CPU."""
    from dhd_tpu_torch.eval.rayiou import (PC_RANGE, VOXEL_SIZE, FREE_ID,
                                           generate_lidar_rays, march,
                                           ray_endpoints,
                                           rayiou_from_outputs,
                                           scene_origins)
    from dhd_tpu_torch.ops.dvr import render

    infos = scene_infos()
    origins = scene_origins(infos, 6)
    check(len(origins) >= 8, f"{len(origins)} origins")
    pred, gt = occupancy_scene(0, shape)
    args = ([pred], [gt], [origins])
    res, ms = {}, {}
    rayiou_from_outputs(*args, device=dev)                # warm-up
    cpu = torch.device("cpu")
    sides = (("card", dev), ("cpu", cpu))
    for (side, where), n in zip(sides, (3, 1)):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            res[side] = rayiou_from_outputs(*args, device=where)
            times.append(1e3 * (time.perf_counter() - t0))
        ms[side] = statistics.median(times)
    diff = max(abs(res["card"][k] - res["cpu"][k])
               for k in ("RayIoU", "RayIoU@1", "RayIoU@2", "RayIoU@4"))
    rays = generate_lidar_rays()
    o_vox, ends = ray_endpoints(rays, origins, PC_RANGE, VOXEL_SIZE)
    hits, march_ms = {}, {}
    for side, where in sides:
        occ = torch.as_tensor(np.stack([pred, gt]) != FREE_ID, device=where)
        r = len(ends)
        inputs = (occ.reshape(-1), shape,
                  torch.from_numpy(np.tile(o_vox, (2, 1))).to(where),
                  torch.from_numpy(np.tile(ends, (2, 1))).to(where),
                  torch.arange(2, device=where).repeat_interleave(r)
                  * int(np.prod(shape)))
        if side == "card":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        hits[side] = [t.cpu().numpy() for t in march(*inputs)]
        march_ms[side] = 1e3 * (time.perf_counter() - t0)
    moved = ~(hits["card"][1] == hits["cpu"][1]).all(axis=1)
    same_d = np.abs(hits["card"][0] - hits["cpu"][0])[~moved]
    print(f"phase 21: RayIoU card {res['card']['RayIoU']:.6f} / @1 "
          f"{res['card']['RayIoU@1']:.6f} / @2 {res['card']['RayIoU@2']:.6f}"
          f" / @4 {res['card']['RayIoU@4']:.6f}, CPU "
          f"{res['cpu']['RayIoU']:.6f}: largest difference {diff:.3e} (tol "
          f"{RAYIOU_TOL}); {len(origins)} origins x {len(rays)} rays x 2 "
          f"grids = {2 * len(ends)} rays in one march: {int(moved.sum())} "
          f"({moved.mean():.2e}) at another voxel than on the CPU (max "
          f"{RAY_MOVED_MAX}), the others' distances within "
          f"{same_d.max():.3e} voxels; {ms['card']:.2f} ms/sample on the "
          f"card (median of 3), {ms['cpu']:.2f} on the CPU, the march "
          f"alone {march_ms['card']:.2f} and {march_ms['cpu']:.2f} ms (the "
          f"rest: the host's fan, endpoints and per-class counts); on "
          f"{card}",
          flush=True)
    check(diff <= RAYIOU_TOL and moved.mean() <= RAY_MOVED_MAX,
          f"RayIoU card vs CPU: {diff:.3e}, {moved.mean():.2e} rays moved")

    # the density render over the same scene: sigma (1, 1, Z, Y, X), the
    # fan from the first origin to 30 m, l1 loss against its own length
    occ = (gt != FREE_ID).transpose(2, 1, 0)
    sigma = np.where(occ, 2.0, 0.02).astype(np.float32)[None, None]
    o = o_vox[0][None, None]
    pts = ((rays * 30.0 + origins[0] - np.asarray(PC_RANGE[:3], np.float32))
           / VOXEL_SIZE).astype(np.float32)[None]
    tindex = np.zeros(pts.shape[:2], np.float32)
    out, dvr_ms = {}, {}
    for side, where in sides:
        case = [torch.from_numpy(a).to(where) for a in (sigma, o, pts,
                                                        tindex)]
        if side == "card":
            render(*case)                                  # warm-up
        t0 = time.perf_counter()
        got = [t.cpu().numpy() for t in render(*case)]
        dvr_ms[side] = 1e3 * (time.perf_counter() - t0)
        out[side] = got
    errs = []
    for k in (0, 2):                     # pred_dist, grad_sigma
        a, b = out["card"][k].ravel(), out["cpu"][k].ravel()
        e = np.abs(a - b) / max(1e-6, float(np.abs(b).max()))
        errs.append((float(e.max()), float((e > DVR_TOL).mean())))
    valid = float((out["cpu"][0] >= 0).mean())
    print(f"phase 21 dvr.render: {pts.shape[1]} rays through sigma "
          f"{sigma.shape}, l1, card vs CPU: pred_dist largest diff "
          f"{errs[0][0]:.3e} of its peak ({errs[0][1]:.2e} of rays past "
          f"{DVR_TOL}), grad_sigma {errs[1][0]:.3e} ({errs[1][1]:.2e} of "
          f"voxels past it); {valid:.4f} of rays valid; {dvr_ms['card']:.2f}"
          f" ms on the card, {dvr_ms['cpu']:.2f} on the CPU; on {card}",
          flush=True)
    check(valid > 0.5 and all(share <= RAY_MOVED_MAX for _, share in errs),
          f"dvr.render card vs CPU: {errs}, valid {valid}")


def write_nuscenes_fixture(root, n_samples: int = 2,
                           img_wh=(1600, 900), grid=(200, 200, 16)):
    """An on-disk nuScenes-format fixture of ``n_samples`` samples in one
    scene: six JPEG cameras at nuScenes' 1600x900 with nuScenes-like
    intrinsics, a 34,720-point lidar sweep, Occ3D ``labels.npz`` and the
    infos pkl; returns the pkl's path."""
    import os
    import pickle

    from PIL import Image

    from dhd_tpu_torch.data.nuscenes import CAM_NAMES

    rng = np.random.default_rng(0)
    infos = []
    for i in range(n_samples):
        cams = {}
        for ci, cam in enumerate(CAM_NAMES):
            path = os.path.join(root, f"{i}_{cam}.jpg")
            Image.fromarray(rng.integers(
                0, 256, (img_wh[1], img_wh[0], 3), dtype=np.uint8)).save(
                path, quality=90)
            yaw = 2 * math.pi * ci / len(CAM_NAMES)
            cams[cam] = {
                "data_path": path,
                "cam_intrinsic": np.array([[1266.4, 0, 816.3],
                                           [0, 1266.4, 491.5], [0, 0, 1]]),
                "sensor2ego_rotation": [math.cos(yaw / 2 - math.pi / 4),
                                        0, 0, math.sin(yaw / 2
                                                       - math.pi / 4)],
                "sensor2ego_translation": [1.7, 0.0, 1.5],
                "ego2global_rotation": [1.0, 0, 0, 0],
                "ego2global_translation": [600.0 + 4.0 * i, 1600.0, 0.0]}
        lidar = os.path.join(root, f"lidar_{i}.bin")
        rng.uniform(-50, 50, (34720, 5)).astype(np.float32).tofile(lidar)
        occ_dir = os.path.join(root, "gts", str(i))
        os.makedirs(occ_dir, exist_ok=True)
        pred, gt = occupancy_scene(i, grid)
        np.savez(os.path.join(occ_dir, "labels.npz"), semantics=gt,
                 mask_lidar=(rng.random(grid) < 0.5).astype(np.uint8),
                 mask_camera=(rng.random(grid) < 0.7).astype(np.uint8))
        infos.append({
            "token": f"tok{i}", "timestamp": 1_000_000 * i,
            "scene_token": "scene0", "lidar_path": lidar,
            "lidar2ego_rotation": [0.7071, 0, 0, 0.7071],
            "lidar2ego_translation": [0.94, 0.0, 1.84],
            "ego2global_rotation": [1.0, 0, 0, 0],
            "ego2global_translation": [600.0 + 4.0 * i, 1600.0, 0.0],
            "occ_path": occ_dir, "cams": cams})
    pkl = os.path.join(root, "infos.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"infos": infos, "metadata": {"version": "smoke"}}, f)
    return pkl


def phase_eval_ann_file(dev, kernels, card, preset="dhd_s",
                        img_wh=(1600, 900), grid=(200, 200, 16)):
    """``cli/test --ann-file --eval ray-iou`` on a 2-sample fixture of
    nuScenes' format and image size (PIL decodes, resizes and crops each
    1600x900 JPEG to 256x704): both samples evaluated in order, B1 and its
    plan kernels once a sample, RayIoU and mIoU printed; ms per sample of
    the whole run (data pipeline included)."""
    import tempfile

    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.ops.cuda_build import BUILD_DIR

    want = {k: 2 * v for k, v in eval_launches_per_sample(
        get_config(preset)).items()}
    counted = [fn for name, fn in eval_counters().items() if name in want]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        t0 = time.perf_counter()
        pkl = write_nuscenes_fixture(root, 2, img_wh, grid)
        write_s = time.perf_counter() - t0
        rc, text, launches, wall, peak_gb, seen = run_eval_cli(
            ["--preset", preset, "--ann-file", pkl, "--eval", "ray-iou"],
            counted)
    check(rc == 0 and "evaluated 2 samples" in text
          and "rayiou-samples: tok0 tok1" in text and "RayIoU@4: " in text
          and "===> mIoU: " in text, f"cli/test --ann-file: {text}")
    check(launches == want and len(seen["preds"]) == 2,
          f"cli/test --ann-file: launches {launches}, want {want}")
    for fn in counted:
        kernels[fn.__name__]["launches_by_path"][f"eval_ann_file_{preset}"] \
            = fn.launches
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("RayIoU", "===> mIoU"))]
    print(f"phase 22 ok: cli/test --preset {preset} --ann-file (2 samples, "
          f"6 JPEG cameras at {img_wh[0]}x{img_wh[1]}, written in "
          f"{write_s:.1f} s) --eval ray-iou in {wall:.1f} s, "
          f"{1e3 * wall / 2:.0f} ms/sample with the model's build, the "
          f"data pipeline and the RayIoU march; launches {launches}; peak "
          f"memory {peak_gb:.2f} GB; {'; '.join(lines)}; on {card}",
          flush=True)


def frame_ms(run, batches, n: int = EXPORT_FRAMES):
    """Host wall time of ``run(batch)`` to a synchronize: median of ``n``
    after a warm-up, over ``batches`` in turn."""
    run(batches[0])
    ms = []
    for k in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(batches[k % len(batches)])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ms)


def mb(path) -> float:
    import os
    return os.path.getsize(path) / 1e6


def bn_fp32_check(dev):
    """A bf16 model's eval BatchNorm on the card (C=64, fp32 statistics
    and affine drawn away from init, a bf16 input at DHD-S's 6x64x176):
    its distance in bf16 ulps from the fp32 formula rounded to bf16."""
    from dhd_tpu_torch.nn.layers import BatchNorm2d

    g = torch.Generator(device=dev).manual_seed(0)
    bn = BatchNorm2d(64).eval().to(dev).to(torch.bfloat16)
    with torch.no_grad():
        for t, lo, hi in ((bn.running_mean, -2, 2), (bn.running_var, 0.1, 1),
                          (bn.weight, 0.5, 2), (bn.bias, -1, 1)):
            t.uniform_(lo, hi, generator=g)
        x = (3 * torch.randn((6, 64, 64, 176), generator=g, device=dev)).to(
            torch.bfloat16)
        y = bn(x)
        want = ((x.float() - bn.running_mean[:, None, None])
                * (torch.rsqrt(bn.running_var + bn.eps)
                   * bn.weight)[:, None, None]
                + bn.bias[:, None, None]).to(torch.bfloat16)
    check(bn.weight.dtype == bn.running_var.dtype == torch.float32
          and y.dtype == torch.bfloat16, "bf16 BatchNorm holds bf16 tensors")
    return bf16_ulp_diff(y, want)


def phase_export(dev, kernels, card, root):
    """``cli/export`` in-process, bf16 at full width, B=1: DHD-S as the
    program + weights split and with ``--bake-weights``, DHD-L split (its
    three frames).  Each program loaded fresh with ``torch.export.load``
    must give at least SERVE_ARGMAX_MIN of the live model's voxel classes
    (the same seeded weights) on new batches, launch B1 and its plan once
    a frame and DHD-L's B3, B4 and B5 at its eval forward's counts a
    sample (phase 20); ms/frame of the loaded program against the live
    model's, the file sizes and the export's time.  Returns the DHD-S
    split artifact's path."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.cli.export import batch_inputs, load_program
    from dhd_tpu_torch.cli.export import main as export
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.models import build_model

    ulps = bn_fp32_check(dev)
    check(ulps <= 1, f"bf16 BatchNorm {ulps} ulps from the fp32 formula")
    print(f"phase 23: a bf16 model's BatchNorm keeps fp32 statistics and "
          f"affine; on the card its bf16 output lies {ulps} bf16 ulp from "
          f"the fp32 formula's; on {card}", flush=True)
    paths = {}
    for preset, variants in (("dhd_s", ("split", "baked")),
                             ("dhd_l", ("split",))):
        cfg = get_config(preset)
        per = eval_launches_per_sample(cfg)
        counted = [fn for name, fn in eval_counters().items()
                   if name in per]
        model = build_model(cfg, dtype=torch.bfloat16, device=dev)
        examples = [synthetic_batch(cfg, 1, seed=s, with_gt=False)
                    for s in (31, 32)]
        for variant in variants:
            path = f"{root}/{preset}_{variant}.pt2"
            rc, text, _, wall = run_cli(export, [
                "--preset", preset, "--out", path, "--bf16",
                *(["--bake-weights"] if variant == "baked" else [])])
            check(rc == 0 and "exported" in text, f"export {preset}: {text}")
            fn, meta = load_program(path)
            batches = [batch_inputs(b, meta["inputs"], dev)
                       for b in examples]
            for f in counted:
                f.launches = 0
            with torch.no_grad():
                got = [fn(b) for b in batches]
            launches = {f.__name__: f.launches for f in counted}
            want = {k: len(batches) * v for k, v in per.items()}
            check(launches == want, f"exported {preset} {variant}: "
                  f"launches {launches}, want {want}")
            for f in counted:
                by_path = kernels[f.__name__]["launches_by_path"]
                by_path[f"export_{preset}"] = by_path.get(
                    f"export_{preset}", 0) + f.launches
            with torch.no_grad():
                live = [model(b)["occ_logits"].argmax(-1).to(torch.uint8)
                        for b in batches]
            agree = float(np.mean([(g == w).float().mean().item()
                                   for g, w in zip(got, live)]))
            check(agree >= SERVE_ARGMAX_MIN, f"exported {preset} {variant}: "
                  f"{agree:.6f} of voxels agree with the live model")
            with torch.no_grad():
                prog_ms = frame_ms(fn, batches)
                live_ms = frame_ms(lambda b: model(b)["occ_logits"].argmax(
                    -1).to(torch.uint8), batches)
            sizes = f"{mb(path):.2f} MB" + (
                f" + weights {mb(path + '.weights.pt'):.2f} MB"
                if variant == "split" else "")
            print(f"phase 23 ok: cli/export --preset {preset} --bf16 "
                  f"({variant}) in {wall:.1f} s (build, live run, trace, "
                  f"save), {sizes}; loaded fresh: {agree:.6f} of voxels "
                  f"with the live model's class on 2 new batches, launches "
                  f"{launches}; {prog_ms:.2f} ms/frame loaded against "
                  f"{live_ms:.2f} live (median of {EXPORT_FRAMES}); on "
                  f"{card}", flush=True)
            paths[(preset, variant)] = path
            del fn
        del model
        torch.cuda.empty_cache()
    return paths[("dhd_s", "split")]


def int8_conv_check(qmodel, batch, dev):
    """One Int8Conv2d of ``qmodel`` at the input a frame gives it: its
    ``_int_mm`` int32 sums against the exact float64 conv, bit for bit.
    Returns the conv's name and input shape."""
    from dhd_tpu_torch.nn.quant import (Int8Conv2d, activation_scale,
                                        int8_conv_int32,
                                        int8_conv_int32_plain)

    name = "img_backbone.layer1.0.conv2"
    conv = qmodel.get_submodule(name)
    check(isinstance(conv, Int8Conv2d), f"{name} is {type(conv).__name__}")
    seen = []
    h = conv.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    with torch.no_grad():
        qmodel(batch)
    h.remove()
    x = seen[0]
    xq = torch.clamp(torch.round(x.float() / activation_scale(conv.amax)),
                     -127, 127).to(torch.int8)
    wq, _ = conv.quantized_weight()
    args = (conv.stride, conv.padding, conv.dilation)
    got = int8_conv_int32(xq, wq, *args)
    want = int8_conv_int32_plain(xq, wq, *args)
    check(torch.equal(got, want), f"{name}: _int_mm int32 sums differ from "
          f"the exact conv by {int((got - want).abs().max())}")
    return name, tuple(x.shape), int(got.abs().max())


def int8_conv_shapes(qmodel, model, batch):
    """Every distinct conv shape of the int8 backbone, timed on the input a
    frame gives it: the whole Int8Conv2d (quantize, im2col, ``_int_mm``,
    dequantize), ``_int_mm`` alone, the plain (float64) int32 sums, and
    the bf16 cuDNN conv it replaces; and the Int8Conv2d's bound (its bf16
    input and output and fp weight once against the card's memory rate,
    2 M K N int8 operations against its int8 rate).  [(input shape,
    weight shape, count, int8 ms, _int_mm ms, plain ms, bf16 ms, bound
    ms, bound_by)]."""
    import torch.nn.functional as F

    from dhd_tpu_torch.nn.quant import (Int8Conv2d, activation_scale,
                                        int8_conv_int32_plain)

    inputs, names = {}, {}
    hooks = []
    for name, m in qmodel.named_modules():
        if isinstance(m, Int8Conv2d):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a, name=name: inputs.setdefault(name, a[0])))
    with torch.no_grad():
        qmodel(batch)
    for h in hooks:
        h.remove()
    for name, x in inputs.items():
        m = qmodel.get_submodule(name)
        key = (tuple(x.shape), tuple(m.weight.shape), m.stride, m.padding)
        names.setdefault(key, []).append(name)
    rows = []
    with torch.no_grad():
        for key, group in names.items():
            q = qmodel.get_submodule(group[0])
            fp = model.get_submodule(group[0])
            x = inputs[group[0]]
            xq = torch.clamp(torch.round(x.float() / activation_scale(
                q.amax)), -127, 127).to(torch.int8)
            wq, _ = q.quantized_weight()
            args = (q.stride, q.padding, q.dilation)
            y = q(x)
            b, cin, _, _ = x.shape
            co, _, kh, kw = wq.shape
            m_rows = b * y.shape[2] * y.shape[3]
            k = -(-cin * kh * kw // 8) * 8
            a = torch.zeros((m_rows, k), dtype=torch.int8, device=x.device)
            w = torch.zeros((-(-co // 8) * 8, k), dtype=torch.int8,
                            device=x.device)
            nbytes = (x.numel() * x.element_size() + y.numel()
                      * y.element_size() + fp.weight.numel()
                      * fp.weight.element_size())
            ops = 2 * m_rows * cin * kh * kw * co
            bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)
            rows.append((key[0], key[1], len(group),
                         time_ms(lambda: q(x), iters=20),
                         time_ms(lambda: torch._int_mm(a, w.t()), iters=20),
                         time_ms(lambda: int8_conv_int32_plain(xq, wq, *args),
                                 iters=5),
                         time_ms(lambda: F.conv2d(
                             x, fp.weight, fp.bias, fp.stride, fp.padding,
                             fp.dilation), iters=20),
                         1e3 * bound,
                         "bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / INT8_OPS_PER_S else "operations"))
    return rows


def phase_int8(dev, kernels, card, root, fp_path):
    """DHD-S bf16 ``cli/export --int8`` (2 synthetic calibration batches):
    over 3 held-out seeds its voxel argmax flips against the fp program
    (phase 23's) on at most INT8_FLIP_MAX of voxels; one Int8Conv2d's
    ``_int_mm`` sums equal the exact conv's; ms/frame fp against int8
    (loaded programs); a frame's device busy time, int8 against fp
    (torch.profiler, the live models), and the int8 convs' share of it;
    each backbone conv shape's int8 and bf16 cuDNN times."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.cli.export import (batch_inputs, calibration_batches,
                                          load_program)
    from dhd_tpu_torch.cli.export import main as export
    from dhd_tpu_torch.cli.export import parse_args as export_args
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.models import build_model
    from dhd_tpu_torch.nn.quant import (DEFAULT_PREFIXES, calibrate_int8,
                                        quantize_model, targeted_convs)
    from dhd_tpu_torch.profiling import trace_device

    cfg = get_config("dhd_s")
    per = eval_launches_per_sample(cfg)
    counted = [fn for name, fn in eval_counters().items() if name in per]
    path = f"{root}/dhd_s_int8.pt2"
    argv = ["--preset", "dhd_s", "--out", path, "--bf16", "--int8"]
    rc, text, _, wall = run_cli(export, argv)
    model = build_model(cfg, dtype=torch.bfloat16, device=dev)
    n_convs = len(targeted_convs(model, DEFAULT_PREFIXES))
    check(rc == 0 and f"calibrated {n_convs} conv activation scales (2 "
          f"synthetic batches" in text, f"export --int8: {text}")
    q_fn, meta = load_program(path)
    fp_fn, _ = load_program(fp_path)
    batches = [batch_inputs(synthetic_batch(cfg, 1, seed=s, with_gt=False),
                            meta["inputs"], dev) for s in (41, 42, 43)]
    for f in counted:
        f.launches = 0
    with torch.no_grad():
        q_out = [q_fn(b) for b in batches]
    launches = {f.__name__: f.launches for f in counted}
    check(launches == {k: 3 * v for k, v in per.items()},
          f"int8 program: launches {launches}")
    for f in counted:
        kernels[f.__name__]["launches_by_path"]["int8_dhd_s"] = f.launches
    with torch.no_grad():
        fp_out = [fp_fn(b) for b in batches]
    flips = [float((q != f).float().mean()) for q, f in zip(q_out, fp_out)]
    flip = float(np.mean(flips))
    check(flip < INT8_FLIP_MAX, f"int8 flips {flip:.4%} of voxels (max "
          f"{INT8_FLIP_MAX:.0%})")
    with torch.no_grad():
        q_ms, fp_ms = frame_ms(q_fn, batches), frame_ms(fp_fn, batches)

    calib, _ = calibration_batches(cfg, export_args(argv), meta["inputs"],
                                   dev)
    qmodel = quantize_model(model, calibrate_int8(model, calib),
                            DEFAULT_PREFIXES)
    conv_name, conv_in, peak = int8_conv_check(qmodel, batches[0], dev)
    with torch.no_grad():
        busy = {name: sum(trace_device(lambda m=m: m(batches[0]),
                                       dev)["ops"].values())
                for name, m in (("int8", qmodel), ("fp", model))}
    rows = int8_conv_shapes(qmodel, model, batches[0])
    int8_ms = sum(r[2] * r[3] for r in rows)
    bf16_ms = sum(r[2] * r[6] for r in rows)
    print(f"phase 24 ok: cli/export --preset dhd_s --bf16 --int8 in "
          f"{wall:.1f} s, {mb(path):.2f} MB + weights "
          f"{mb(path + '.weights.pt'):.2f} MB; argmax flips against the fp "
          f"program {flip:.4%} of voxels (seeds "
          f"{', '.join(f'{x:.4%}' for x in flips)}; "
          f"max {INT8_FLIP_MAX:.0%}; a TPU v5e read {INT8_FLIP_V5E:.4%}, "
          f"README.md, not this card); launches {launches}; {conv_name} "
          f"at {conv_in}: _int_mm int32 sums equal the exact conv's "
          f"(peak |sum| {peak}); {q_ms:.2f} ms/frame int8 against "
          f"{fp_ms:.2f} fp (loaded programs, median of {EXPORT_FRAMES}); "
          f"device busy a frame {busy['int8']:.2f} ms int8 against "
          f"{busy['fp']:.2f} fp (live models, torch.profiler), of which "
          f"the backbone's convs {int8_ms:.2f} ms int8 "
          f"({int8_ms / busy['int8']:.3f}) "
          f"against {bf16_ms:.2f} bf16 cuDNN (each shape by CUDA events "
          f"times its count); on {card}" + "".join(
              f"\n    conv x{n} in {x} w {w}: int8 {a:.4f} ms (_int_mm "
              f"{m:.4f}), plain (float64) {p:.4f}, bf16 cuDNN {c:.4f}, "
              f"bound {bd:.4f} ({by})"
              for x, w, n, a, m, p, c, bd, by in rows), flush=True)
    del model, qmodel
    torch.cuda.empty_cache()
    return path


def phase_benchmark_exported(dev, card, path):
    """``cli/benchmark --what exported --artifact`` on phase 23's DHD-S
    program: a finite ms/iter, B1 and its plan launched."""
    from dhd_tpu_torch.cli.benchmark import main as bench
    from dhd_tpu_torch.ops import mghs_pool_cuda
    from dhd_tpu_torch.ops.mghs_pool_cuda import pool_plan_cuda

    rc, text, launches, wall = run_cli(
        bench, ["--what", "exported", "--artifact", path, "--iters", "10"],
        (mghs_pool_cuda, pool_plan_cuda))
    m = re.search(r"exported artifact .*?: ([\d.]+) ms/iter = ([\d.]+) "
                  r"samples/s", text)
    check(rc == 0 and m is not None and math.isfinite(float(m.group(1)))
          and launches["mghs_pool_cuda"] == 11
          and launches["pool_plan_cuda"] == 11,
          f"benchmark --what exported: launches {launches}: {text}")
    print(f"phase 25 ok: cli/benchmark --what exported --artifact "
          f"{path.rsplit('/', 1)[-1]} in {wall:.1f} s: "
          f"{text.splitlines()[0]}; launches {launches}; on {card}",
          flush=True)


def ddp_steps(cfg, dev, batch, steps: int = DDP_STEPS):
    """``steps`` bf16 train steps of ``cfg`` from seed 0 on ``batch``:
    the metrics of each and the BatchNorm statistics after each."""
    from dhd_tpu_torch.train import train_step

    model, opt, ema, gen = train_setup(cfg, dev)
    out = []
    for _ in range(steps):
        m = train_step(model, opt, ema, batch, gen,
                       compute_dtype=torch.bfloat16)
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.clone() for k, v in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}))
    return out


def step_errors(a1, a2, abn2, b1, b2, bbn2):
    """Relative differences of two runs of :func:`ddp_steps`: the first
    step's grad_norm, the second step's metrics, and its BatchNorm
    statistics (of each tensor's peak)."""
    yield abs(a1["grad_norm"] - b1["grad_norm"]) / b1["grad_norm"]
    yield from (abs(a2[k] - v) / abs(v) for k, v in b2.items())
    yield from (float((abn2[k] - v).abs().max()
                      / v.abs().max().clamp_min(1e-12))
                for k, v in bbn2.items())


def phase_ddp(dev, kernels, card):
    """The distributed path on one card: ``initialize_distributed`` starts
    a one-process NCCL group (MASTER_ADDR 127.0.0.1, a free port); two
    DHD-S bf16 train steps at B=4 (a varied rig) through it (SyncBN's
    all-reduce, the losses' global sums, the gradients' all-reduce)
    against the same two steps without a group, run twice; then
    ``cli/test --synthetic`` (2 samples) under the group.  The group is
    destroyed at the end, also on a failure, which still raises."""
    import os
    import socket

    from dhd_tpu_torch import get_config, parallel
    from dhd_tpu_torch.cli.test import main as evaluate
    from dhd_tpu_torch.data import synthetic_batch

    cfg = get_config("dhd_s")
    # a varied rig: on the plain one the camera embedding's BatchNorm
    # normalises rounding noise (ROADMAP.md §C.3), and two runs of one
    # step part by percents
    batch = on_device(synthetic_batch(cfg, 4, seed=0, with_gt=True,
                                      varied_rig=True), dev)
    counted = list(eval_counters().values())
    plain, control = ddp_steps(cfg, dev, batch), ddp_steps(cfg, dev, batch)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        check(parallel.initialize_distributed(dev, always=True)
              and parallel.is_distributed(), "no process group")
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        group = ddp_steps(cfg, dev, batch)
        torch.cuda.synchronize()
        ddp_s = time.perf_counter() - t0
        for fn in counted:
            if fn.launches:
                kernels[fn.__name__]["launches_by_path"]["ddp_train"] = \
                    fn.launches
        launches = {fn.__name__: fn.launches for fn in counted
                    if fn.launches}
        check(launches == {"mghs_pool_cuda": DDP_STEPS,
                           "pool_plan_cuda": DDP_STEPS},
              f"ddp train: launches {launches}")
        (m1, bn1), (m2, bn2) = group
        (p1, pbn1), (p2, pbn2) = plain
        losses1 = {k: v for k, v in m1.items() if k != "grad_norm"}
        check(losses1 == {k: v for k, v in p1.items() if k != "grad_norm"}
              and all(torch.equal(bn1[k], pbn1[k]) for k in bn1),
              f"ddp step 1: losses {m1} against {p1}, or BatchNorm "
              f"statistics not bit for bit")
        (c1, _), (c2, cbn2) = control
        spread = max(step_errors(c1, c2, cbn2, p1, p2, pbn2))
        err = max(step_errors(m1, m2, bn2, p1, p2, pbn2))
        bar = DDP_SPREAD * spread + DDP_FLOOR
        check(err <= bar, f"ddp: grad_norm and step 2 {err:.2e} from the "
              f"steps without a group, whose spread is {spread:.2e}")
        rc, text, _, wall = run_cli(evaluate, ["--preset", "dhd_s",
                                               "--synthetic"])
        check(rc == 0 and "evaluated 2 samples" in text
              and "===> mIoU: " in text and parallel.is_distributed(),
              f"cli/test under the group: {text}")
        print(f"phase 26 ok: a one-process NCCL group "
              f"(initialize_distributed, port {port}): {DDP_STEPS} DHD-S "
              f"bf16 train steps at B=4 through SyncBN, the global loss "
              f"sums and the gradients' all-reduce in {ddp_s:.1f} s, "
              f"launches {launches}; step 1's losses and BatchNorm "
              f"statistics bit for bit the steps without a group; "
              f"grad_norm and step 2's metrics and statistics within "
              f"{err:.2e} (relative) of them, two runs without a group "
              f"{spread:.2e} apart (bar {bar:.2e}); cli/test --synthetic "
              f"under the group in {wall:.1f} s: {text.splitlines()[-1]}; "
              f"on {card}",
              flush=True)
    finally:
        parallel.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(not parallel.is_distributed(), "the process group outlived the "
          "phase")


def phase_train_ann_file(dev, card, root, preset="dhd_s",
                         img_wh=(1600, 900)):
    """``cli/train --ann-file`` for 2 steps at B=2 on a 4-sample fixture
    of phase 22's format (six 1600x900 JPEG cameras and a lidar sweep a
    sample): the train pipeline's augmentation and its lidar projection
    through ``native/`` (built with g++ on this host), finite losses; the
    loader's samples/s alone (8 threads) beside the step time."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.cli.train import main as train
    from dhd_tpu_torch.data.loader import PrefetchLoader
    from dhd_tpu_torch.data.nuscenes import NuScenesOccDataset
    from dhd_tpu_torch.data.pipeline import SamplePipeline
    from dhd_tpu_torch.ops import mghs_pool_cuda

    pkl = write_nuscenes_fixture(root, 4, img_wh)
    rc, text, launches, wall = run_cli(train, [
        "--preset", preset, "--ann-file", pkl, "--steps", "2",
        "--batch-size", "2", "--log-interval", "1"], (mghs_pool_cuda,))
    lines = [ln for ln in text.splitlines() if "loss_total=" in ln]
    losses = [float(kv.split("=")[1]) for ln in lines
              for kv in ln.split(") ", 1)[1].split()]
    check(rc == 0 and len(lines) == 2
          and all(math.isfinite(v) for v in losses)
          and launches["mghs_pool_cuda"] == 2,
          f"cli/train --ann-file: launches {launches}: {text}")
    step_s = float(re.search(r"\(([\d.]+)s/it\)", lines[-1]).group(1))
    cfg = get_config(preset)
    ds = NuScenesOccDataset(pkl, "", num_adj_frames=cfg.num_adj_frames,
                            stereo=cfg.stereo)
    loader = PrefetchLoader(ds, SamplePipeline(cfg, is_train=True, seed=0),
                            2, shuffle=True, num_workers=8, prefetch=3)
    t0 = time.perf_counter()
    n = sum(len(b["imgs"]) for _ in range(2) for b in loader)
    load_s = time.perf_counter() - t0
    print(f"phase 27 ok: cli/train --preset {preset} --ann-file (4 "
          f"samples, six {img_wh[0]}x{img_wh[1]} JPEG cameras and a lidar "
          f"sweep each, native/ built on this host) 2 steps at B=2 in "
          f"{wall:.1f} s with the model's build: {step_s:.2f} s/it as the "
          f"CLI prints it, losses finite; the train loader alone "
          f"{n / load_s:.2f} samples/s ({n} samples, 8 threads, PIL "
          f"decode, augmentation, lidar depth and height maps); on {card}"
          + "".join(f"\n    {ln}" for ln in lines), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.ops import cuda_build
    from dhd_tpu_torch.ops.mghs_pool_cuda import pool_plan_cuda

    dev = torch.device("cuda")
    card = smi_name_power()
    t0 = time.perf_counter()
    logs = cuda_build.build(cuda_build.SOURCES)
    ptxas = {name: ptxas_lines(log) for name, log in logs.items()}
    print(f"phase 1 ok: {card}; {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; built "
          f"{list(cuda_build.SOURCES)} in {time.perf_counter() - t0:.1f} s "
          f"[{'; '.join(ln for lines in ptxas.values() for ln in lines)}]; "
          f"{tf32_mode()} (the fp32 GPU-vs-CPU phases 4, 8, 13, 17 turn "
          f"TF32 off)", flush=True)

    kernels: dict = {}
    phase_plan(dev, kernels, "dhd_s",
               phase_kernel(dev, kernels, ptxas=ptxas))
    phase_serve(dev, kernels, card)
    kernels["pool_plan_cuda"]["launches_by_path"] = {
        "dhd_s_serve_uncached": phase_serve_uncached(
            dev, card, (pool_plan_cuda,))["pool_plan_cuda"]}
    with full_fp32():
        phase_tiny(dev)
    phase_cost_volume(dev, kernels, ptxas=ptxas)
    phase_plan(dev, kernels, "dhd_m",
               phase_kernel(dev, kernels, "dhd_m", ptxas))
    phase_stream(dev, kernels, card)
    with full_fp32():
        phase_small_stream(dev, get_config("dhd_micro_stereo"), 8)
    phase_attention(dev, kernels, ptxas)
    phase_layer_norm(dev, kernels, ptxas)
    phase_cost_volume(dev, kernels, "dhd_l", ptxas)
    phase_plan(dev, kernels, "dhd_l",
               phase_kernel(dev, kernels, "dhd_l", ptxas))
    phase_stream(dev, kernels, card, "dhd_l")
    with full_fp32():
        phase_small_stream(dev, tiny_dhd_l(), 13)
    phase_segment_sum(dev, kernels, ptxas)
    phase_plan(dev, kernels, "hot",
               phase_kernel(dev, kernels, "hot", ptxas))
    phase_cli(dev, kernels)
    phase_train(dev, kernels, card)
    with full_fp32():
        phase_train_small(dev)
    phase_train_dhd_l(dev, kernels, card)
    phase_eval(dev, kernels, card)
    phase_eval_dhd_l(dev, kernels, card)
    phase_rayiou(dev, card)
    phase_eval_ann_file(dev, kernels, card)
    import tempfile

    from dhd_tpu_torch.ops.cuda_build import BUILD_DIR
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        fp_path = phase_export(dev, kernels, card, root)
        phase_int8(dev, kernels, card, root, fp_path)
        phase_benchmark_exported(dev, card, fp_path)
    phase_ddp(dev, kernels, card)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        phase_train_ann_file(dev, card, root)
    for kern in kernels.values():
        kern["launches"] = sum(kern["launches_by_path"].values())
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
