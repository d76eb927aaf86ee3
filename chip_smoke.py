#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dhd_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. the card's name and power limit; build the CUDA kernels from
   ``dhd_tpu_torch/csrc`` (one nvcc per source, all started together);
2. kernel vs plain: ``mghs_pool_cuda`` against its plain PyTorch version at
   DHD-S shapes in bf16 (fp32 sums), every element within one bf16 ulp;
   times by CUDA events, median of 30 launches each;
3. serving: DHD-S at full width (B=1, 6 cameras, 256x704) in bf16 with
   seeded random weights and a cached pool plan answers 5 frames; each
   kernel must launch once per frame; one frame is repeated with the plain
   pooling forced and must agree;
4. small reference: dhd_tiny in fp32 on the GPU against the same weights on
   the CPU (plain path), TF32 off.

Then one JSON line listing the kernels, the card's ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
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
SERVE_REL_TOL = 2e-2        # bf16 kernel path vs bf16 plain path, of peak
SERVE_ARGMAX_MIN = 0.999
TINY_REL_TOL = 2e-4         # fp32 GPU vs fp32 CPU, of peak


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def rel_to_peak(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(1e-3, float(b.abs().max()))


def phase_kernel(dev, kernels):
    """B1 kernel vs its plain version at DHD-S geometry."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.models import build_batch_pool_plan
    from dhd_tpu_torch.ops import mghs_pool_cuda, mghs_pool_plan_plain

    cfg = get_config("dhd_s")
    vt = cfg.vt
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

    before = mghs_pool_cuda.launches
    bev_k, vox_k = mghs_pool_cuda(depth, feat, band_mask, plan)
    torch.cuda.synchronize()
    check(mghs_pool_cuda.launches == before + 1, "kernel launch not counted")
    bev_p, vox_p = mghs_pool_plan_plain(depth, feat, band_mask, plan)
    torch.cuda.synchronize()
    ulps = max(bf16_ulp_diff(bev_k, bev_p), bf16_ulp_diff(vox_k, vox_p))
    err = max(float((bev_k.float() - bev_p.float()).abs().max()),
              float((vox_k.float() - vox_p.float()).abs().max()))
    check(ulps <= POOL_ULP_TOL,
          f"mghs_pool_cuda differs from plain by {ulps} bf16 ulps")
    check(float(vox_k.float().abs().sum()) > 0, "vox is all zero")

    ms = time_ms(lambda: mghs_pool_cuda(depth, feat, band_mask, plan))
    plain_ms = time_ms(
        lambda: mghs_pool_plan_plain(depth, feat, band_mask, plan))

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
    per_pillar = (plan.starts[1:] - plan.starts[:-1])
    busiest = int(per_pillar.max())
    mean_pts = n_valid / max(1, int((per_pillar > 0).sum()))
    c = vt.out_channels
    nbytes = (2 * (vox_k.numel() + bev_k.numel() + depth.numel()
                   + feat.numel() + band_mask.numel())
              + 8 * n_valid + 4 * plan.starts.numel())
    flops = n_valid * c * 2 + n_gated * c      # multiply + bev add; vox add
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    kernels["mghs_pool_cuda"] = {
        "name": "mghs_pool_cuda", "route": "cuda",
        "source": "dhd_tpu_torch/csrc/mghs_pool.cu",
        "replaces": "dhd_tpu/ops/pallas_pool.py:240",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    print(f"phase 2 ok: mghs_pool_cuda vs plain at DHD-S: "
          f"P={plan.dix_s.numel()} points ({n_valid} in grid, {n_gated} "
          f"gated on) -> vox "
          f"{tuple(vox_k.shape)}, bev {tuple(bev_k.shape)} bf16; max abs err "
          f"{err:.3e}, max {ulps} bf16 ulp (tol {POOL_ULP_TOL}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{kernels['mghs_pool_cuda']['bound_ms']:.4f} ms "
          f"({nbytes / 1e6:.1f} MB); points per non-empty pillar: mean "
          f"{mean_pts:.1f}, max {busiest}", flush=True)


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
    kernels["mghs_pool_cuda"]["launches"] = launches
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
    stages = stage_ms(model, frames[1])
    busy, top = device_busy_ms(model, frames[1])
    frame = statistics.median(frame_ms)
    print(f"phase 3 breakdown: plain-pooling path "
          f"{statistics.median(plain_ms):.2f} ms/frame median vs kernel path "
          f"{frame:.2f}; stage device ms (CUDA events) "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + (f"; device busy {busy:.2f} ms of {frame:.2f} ms/frame, idle "
             f"share {1 - busy / frame:.3f}; top kernels (ms) "
             + ", ".join(f"{n[:48]} {t:.3f}" for n, t in top)
             if busy > 0 else "; device busy: not measured (no device "
             "time in the profiler)"), flush=True)
    del model, plain


def stage_ms(model, frame) -> dict:
    """Device time of each top-level stage of one frame: CUDA events
    recorded by forward hooks around every child module."""
    events: dict = {}

    def record(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.setdefault(name, []).append(ev)

    hooks = []
    for name, mod in model.named_children():
        hooks.append(mod.register_forward_pre_hook(
            lambda *_, n=name: record(n)))
        hooks.append(mod.register_forward_hook(lambda *_, n=name: record(n)))
    record("frame")
    model(frame)
    record("frame")
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return {n: ev[0].elapsed_time(ev[1]) for n, ev in events.items()}


def device_busy_ms(model, frame, n_top: int = 6):
    """Summed kernel time of one frame from torch.profiler, and the
    kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model(frame)
        torch.cuda.synchronize()
    kern = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda kv: -kv[1])
    return sum(t for _, t in kern), kern[:n_top]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from dhd_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    # fp32 comparisons (phase 4) in full fp32: no TF32 in cuDNN or matmul
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi_name_power()
    t0 = time.perf_counter()
    logs = cuda_build.build(cuda_build.SOURCES)
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 1 ok: {card}; {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; built "
          f"{list(cuda_build.SOURCES)} in {time.perf_counter() - t0:.1f} s "
          f"[{'; '.join(ptxas)}]; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)

    kernels: dict = {}
    phase_kernel(dev, kernels)
    phase_serve(dev, kernels, card)
    phase_tiny(dev)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
