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

Phases 4, 8, 13 and 17 compare fp32 on the GPU with the CPU and turn TF32
off in cuDNN and matmul for their run; the others run in PyTorch's
defaults.

Then one JSON line listing the kernels B1-B5 and B1's plan kernels
(each shape's numbers under
``shapes``, launches per served path, per CLI run and over the timed
train steps of phases 16 and 18 under ``launches_by_path``), the
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
    p_k, p_p = torch.softmax(-cost_k, 1), torch.softmax(-cost_p, 1)
    prob_err = float((p_k - p_p).abs().max())
    check(bool(((p_k - p_p).abs() <= CV_ATOL + CV_RTOL * p_p.abs()).all()),
          f"stereo_cost_volume_cuda probabilities differ from plain by "
          f"{prob_err:.3e} (atol {CV_ATOL}, rtol {CV_RTOL})")
    hit_p = (cost_p - no_bias) > bias / 2
    hit_k = (cost_k - no_bias) > bias / 2
    # the bias goes where the warped channel 0 is exactly 0: the two may
    # part only where the exact warped value is within fp32 rounding
    # (TERM_TOL) of its terms, zero in one order of the fp32 sum only
    flips = (hit_p != hit_k).nonzero(as_tuple=True)
    n_flips = flips[0].numel()
    if n_flips:
        near, terms = warp0_exact(prev, uf, vf, flips)
        # no terms (every tap off the image or zero): 0 in any order
        flip_share = float(torch.where(terms > 0, near.abs() / terms,
                                       math.inf).max())
        check(flip_share <= TERM_TOL, f"bias landed on {n_flips} other "
              f"samples, the exact warped channel 0 there up to "
              f"{flip_share:.3e} of its terms (tol 2^-20)")
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
             f"{flip_share:.2e} of its terms" if n_flips else "the same "
             "samples") + f"); kernel {ms:.4f} ms, plain "
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
