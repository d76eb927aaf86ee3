"""Benchmark and analysis CLI of the port: counterpart of
``dhd_tpu/cli/benchmark.py`` (the reference's tools/analysis_tools/
{benchmark, benchmark_view_transformer, get_flops}.py).

  python -m dhd_tpu_torch.cli.benchmark --preset dhd_s --what full
  python -m dhd_tpu_torch.cli.benchmark --preset dhd_m --what stream
  python -m dhd_tpu_torch.cli.benchmark --preset dhd_s --what pool
  python -m dhd_tpu_torch.cli.benchmark --preset dhd_tiny --what pool \\
      --device cpu
  python -m dhd_tpu_torch.cli.benchmark --preset dhd_s --what train \\
      --batch-size 4
  python -m dhd_tpu_torch.cli.benchmark --what exported --artifact dhd_s.pt2

Modes: ``full`` (one forward), ``stream`` (temporal presets: the streaming
step with a cached pool plan and the rig-static stereo warp plan),
``stages`` (each top-level module alone), ``flops`` (counted by
``torch.utils.flop_counter``), ``cv`` (the stereo cost volume in parts),
``pool`` (the pooling kernels and the raw segment-sum), ``train`` (the
whole train step, in bf16 mixed precision unless ``--fp32``, optionally
with a precomputed pool plan) and ``exported`` (a ``cli/export`` artifact
loaded fresh, ``--artifact``; its preset, batch and device are the
artifact's).  It runs on the GPU
unless ``--device cpu`` is given, where every kernel wrapper takes its
plain version, and raises when there is no GPU and no ``--device``.  The
inputs live on the device before timing; each timed loop runs one warm-up
call, then ``--iters`` calls, and ends in ``torch.cuda.synchronize()``.
Weights are the port's seeded random ones, data synthetic.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dhd_tpu_torch.models.dhd import GEOM_KEYS, stereo_feat_channels

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_s(step: Callable[[], object], iters: int,
            dev: torch.device) -> float:
    """Seconds per call of ``step()``: one warm-up call, then ``iters``
    calls, ended by a device synchronize."""
    step()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    _sync(dev)
    return (time.perf_counter() - t0) / iters


def _print_profile(prof: Dict, module_substr: str, n_ops: int) -> None:
    """Per-range time and the top kernels from a trace_device() result."""
    from dhd_tpu_torch.profiling import module_ms, top_ops
    clock = prof["clock"]
    for name, durs in sorted(prof["modules"].items()):
        mean = (sum(durs[1:]) / len(durs[1:]) if len(durs) > 1
                else durs[0])
        print(f"[profile] module {name}: {mean:.2f} ms/exec x{len(durs)} "
              f"({clock})")
    t = module_ms(prof, module_substr, drop_first=1)
    if t is not None:
        print(f"[profile] {clock} time ({module_substr}): {t:.2f} ms")
    print(f"[profile] top ops by {clock} time:")
    full = prof.get("op_hlo") or {}
    for name, ms, cnt in top_ops(prof, n_ops):
        print(f"  {ms:10.3f} ms  x{cnt:<5d} {name}")
        if name in full:
            print(f"        {full[name][:240]}")


def _profile(args, step: Callable[[], object], dev: torch.device) -> None:
    """Trace a few more calls of ``step``, each a span named 'step' (with
    the model's own spans inside it)."""
    from dhd_tpu_torch.profiling import span, trace_device

    def run():
        for _ in range(min(args.iters, 6)):
            with span("step"):
                step()
    _print_profile(trace_device(run, dev, collapse=not args.profile_detail),
                   "step", args.profile_ops)


def _tensors(arrays: Dict[str, np.ndarray], dev: torch.device,
             dt: torch.dtype) -> Dict[str, torch.Tensor]:
    """Arrays on the device: images in the working dtype, geometry fp32."""
    return {k: torch.as_tensor(v, device=dev,
                               dtype=dt if k == "imgs" else torch.float32)
            for k, v in arrays.items()}


def _randn(rng: np.random.Generator, shape, dev, dt) -> torch.Tensor:
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)
                            ).to(dev, dt)


def _model(cfg, dt, dev):
    from dhd_tpu_torch.models import build_model
    return build_model(cfg, dtype=dt, device=dev,
                       generator=torch.Generator().manual_seed(0))


def _print_setup() -> None:
    """The set-up spans so far (``profiling.span(..., always=True)``),
    seconds summed by name, the kernel builds and loads, and the served
    frames' CUDA graph captures, replays and unit calls run eagerly
    (``models/graphs.py``)."""
    from dhd_tpu_torch.profiling import counters, spans
    total: Dict[str, float] = {}
    for name, _, t0, t1 in spans():
        if name.startswith("setup."):
            total[name] = total.get(name, 0.0) + (t1 - t0) / 1e9
    c = counters()
    print("set-up: " + ", ".join(f"{k.removeprefix('setup.')} {v:.3f} s"
                                 for k, v in total.items())
          + f"; kernel loads {c.get('kernel_loads', 0)}, builds "
          f"{c.get('kernel_builds', 0)}; graph captures "
          f"{c.get('graph_captures', 0)}, replays "
          f"{c.get('graph_replays', 0)}, eager calls "
          f"{c.get('graph_eager_calls', 0)}")


def _key_frame(cfg, batch: Dict[str, np.ndarray], keys) -> Dict:
    """The key frame's arrays of a (frames-major, if temporal) batch."""
    return {k: batch[k][:, 0] if cfg.temporal and k != "bda" else batch[k]
            for k in keys}


def _show(name: str, step: Callable[[], object], args, dev) -> None:
    print(f"{name}: {timed_s(step, args.iters, dev) * 1e3:.2f} ms",
          flush=True)


def run_full(args, cfg, dt, dev, batch) -> None:
    model = _model(cfg, dt, dev)
    b = _tensors(batch, dev, dt)

    def step():
        return model(b)["occ_logits"]
    s = timed_s(step, args.iters, dev)
    print(f"{args.preset} end-to-end: {s * 1e3:.2f} ms/iter "
          f"= {args.batch_size / s:.1f} samples/s")
    _print_setup()
    if args.profile:
        _profile(args, step, dev)


def run_stream(args, cfg, dt, dev, batch) -> None:
    """Streaming serving (the reference's benchmark_sequential.py): the
    previous frame's features come from the cache, and a fixed rig ships
    the pooling plan and the rig-static half of the stereo warp plan,
    built once."""
    from dhd_tpu_torch.models import (build_stream_cv_static,
                                      build_stream_pool_plan)
    if not cfg.temporal:
        raise SystemExit("--what stream needs a temporal preset")
    frame = _tensors(_key_frame(cfg, batch, (
        "imgs", "sensor2ego", "ego2global", "intrins", "post_rots",
        "post_trans", "bda")), dev, dt)
    model = _model(cfg, dt, dev)
    frame["pool_plan"] = build_stream_pool_plan(cfg, frame, device=dev)
    shipped = ["pool_plan"]
    if cfg.stereo and cfg.cv_method != "xla":
        frame["cv_static"] = build_stream_cv_static(cfg, frame, device=dev)
        shipped.append("cv_static")
    print(f"stream frames ship {' and '.join(shipped)} (built once per rig)")
    state = {"cache": model(frame, cache={})[1]}      # bootstrap frame

    def step():
        out, state["cache"] = model(frame, cache=state["cache"])
        return out
    s = timed_s(step, args.iters, dev)
    print(f"{args.preset} streaming inference: {s * 1e3:.2f} ms/iter = "
          f"{args.batch_size / s:.1f} samples/s")
    _print_setup()
    if args.profile:
        _profile(args, step, dev)


def run_flops(args, cfg, dt, dev, batch) -> None:
    """One forward with every plain version (the CUDA kernels are invisible
    to the counter) under ``torch.utils.flop_counter.FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    plain = dataclasses.replace(cfg, pool_method="xla", cv_method="xla",
                                attn_method="xla", ln_method="xla")
    model = _model(plain, dt, dev)
    b = _tensors(batch, dev, dt)
    with FlopCounterMode(display=False) as counter:
        model(b)
    print(f"forward flops: {counter.get_total_flops() / 1e9:.1f} G "
          f"(torch.utils.flop_counter)")
    print("bytes accessed: not counted (the flop counter gives no bytes)")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.1f} M")


def run_cv(args, cfg, dt, dev, batch) -> None:
    """The stereo cost volume at this preset's shapes: (a) the plan build,
    stepwise and from the rig-static half, (b) kernel B3 from a prebuilt
    plan, (c) the whole op the model runs (plan + kernel + softmax)."""
    from dhd_tpu_torch.geometry import create_frustum
    from dhd_tpu_torch.ops import (build_cv_plan, build_cv_static,
                                   cv_plan_from_static, stereo_cost_volume,
                                   stereo_cost_volume_cuda)
    if not cfg.stereo:
        raise SystemExit("--what cv needs a stereo preset")
    vt = cfg.vt
    b, n = args.batch_size, cfg.num_cams
    hs, ws = vt.input_size[0] // 4, vt.input_size[1] // 4
    cs = stereo_feat_channels(cfg)
    rng = np.random.default_rng(0)
    frustum = create_frustum(vt.depth, vt.input_size, 4, vt.sid, device=dev)
    k2s = np.broadcast_to(np.eye(4, dtype=np.float32), (b, n, 4, 4)).copy()
    k2s[..., 0, 3] = 0.3
    k2s[..., 2, 3] = -0.5                          # 0.5 m forward motion
    geom = _tensors(dict(_key_frame(cfg, batch, ("intrins", "post_rots",
                                                 "post_trans")), k2s=k2s),
                    dev, dt)
    k2s, intr, prot, ptra = (geom[k] for k in ("k2s", "intrins",
                                               "post_rots", "post_trans"))
    prev = _randn(rng, (b, n, hs, ws, cs), dev, dt)
    curr = _randn(rng, (b, n, hs, ws, cs), dev, dt)
    bias = cfg.depthnet_cfg.bias
    tag = " [plain, cpu]" if dev.type == "cpu" else ""

    _show("plan build", lambda: build_cv_plan(frustum, k2s, intr, prot,
                                              ptra, hs, ws), args, dev)
    static = build_cv_static(frustum, intr, prot, ptra, hs, ws)
    _show("plan build from cv_static (cv_plan_from_static)",
          lambda: cv_plan_from_static(static, k2s), args, dev)
    uf, vf = build_cv_plan(frustum, k2s, intr, prot, ptra, hs, ws)
    p2 = prev.reshape(b * n, hs, ws, cs)
    c2 = curr.reshape(b * n, hs, ws, cs)
    _show(f"kernel+layout (prebuilt plan){tag}",
          lambda: stereo_cost_volume_cuda(p2, c2, uf, vf, bias), args, dev)
    _show(f"full stereo_cost_volume (plan+kernel+softmax){tag}",
          lambda: stereo_cost_volume(prev, curr, frustum, k2s, intr, prot,
                                     ptra, bias=bias, method=cfg.cv_method),
          args, dev)
    _show(f"full stereo_cost_volume with cv_static{tag}",
          lambda: stereo_cost_volume(prev, curr, frustum, k2s, intr, prot,
                                     ptra, bias=bias, method=cfg.cv_method,
                                     static=static), args, dev)


def run_pool(args, cfg, dt, dev, batch) -> None:
    """The MGHS pooling stage at this preset's scale: the plain index_add_
    pooling, kernel B1 with the plan built in the call and with a cached
    plan (serving), then the raw segment-sum, plain and kernel B2."""
    from dhd_tpu_torch.geometry import create_frustum, frustum_to_ego
    from dhd_tpu_torch.ops import (build_pool_plan, compute_pool_indices,
                                   mghs_pool, mghs_pool_cuda,
                                   segment_sum_pooling, sorted_segment_sum,
                                   sorted_segment_sum_plain)
    vt = cfg.vt
    fh, fw = vt.feat_size
    b, n = args.batch_size, cfg.num_cams
    c = vt.out_channels
    rng = np.random.default_rng(0)
    geom = _tensors(_key_frame(cfg, batch, GEOM_KEYS), dev, dt)
    coords = frustum_to_ego(
        create_frustum(vt.depth, vt.input_size, vt.downsample, vt.sid,
                       device=dev), *(geom[k] for k in GEOM_KEYS))
    idx = compute_pool_indices(coords, vt)
    depth = torch.softmax(_randn(rng, (b, n, vt.D, fh, fw), dev,
                                 torch.float32), dim=2).to(dt)
    feat = _randn(rng, (b, n, fh, fw, c), dev, dt)
    bmask = torch.from_numpy(rng.integers(0, 2, (b, n, fh, fw, 3)).astype(
        np.float32)).to(dev, dt)
    depth_px = depth.permute(0, 1, 3, 4, 2).contiguous()   # pixel-major
    tag = " [plain, cpu]" if dev.type == "cpu" else ""

    _show("mghs_pool plain index_add_",
          lambda: mghs_pool(depth, feat, bmask, idx, vt), args, dev)
    _show(f"mghs_pool cuda (plan built in the call){tag}",
          lambda: mghs_pool_cuda(depth_px, feat, bmask,
                                 build_pool_plan(idx, vt, depth.shape)),
          args, dev)
    plan = build_pool_plan(idx, vt, depth.shape, fit_scratch=True)
    _show(f"mghs_pool cuda + plan (serving){tag}",
          lambda: mghs_pool_cuda(depth_px, feat, bmask, plan), args, dev)

    # the raw segment-sum at this scale, ids uniform over 1.5 V: a third
    # of the points are dropped
    p_pts = b * n * vt.D * fh * fw
    v = vt.z_fine.size * vt.y.size * vt.x.size * b
    vals = _randn(rng, (p_pts, c), dev, dt)
    seg = torch.from_numpy(rng.integers(0, int(v * 1.5), p_pts).astype(
        np.int32)).to(dev)
    _show("raw index_add_ segment_sum",
          lambda: sorted_segment_sum_plain(vals, seg, v, dt), args, dev)
    _show(f"raw cuda segment_sum (sorts inside){tag}",
          lambda: segment_sum_pooling(vals, seg, v), args, dev)
    seg_s, order = torch.sort(seg, stable=True)
    order32 = order.to(torch.int32)
    vals_s = vals[order]
    parts = {
        "sort": lambda: torch.sort(seg, stable=True),
        "kernel gathering the rows": lambda: sorted_segment_sum(
            vals, seg_s, v, dt, order=order32),
        "or row gather": lambda: vals[order],
        "+ kernel on sorted rows": lambda: sorted_segment_sum(
            vals_s, seg_s, v, dt)}
    print(f"raw cuda segment_sum split{tag}: " + ", ".join(
        f"{k} {timed_s(f, args.iters, dev) * 1e3:.2f} ms"
        for k, f in parts.items()), flush=True)


def run_stages(args, cfg, dt, dev, batch) -> None:
    """Each top-level module of the model alone, at the shapes it sees in a
    frame: image encoder (backbone + neck), view transformer (depth net,
    HeightNet, pooling), BEV encoder and the three slab UNets."""
    model = _model(cfg, dt, dev)
    vt = cfg.vt
    b, n = args.batch_size, cfg.num_cams
    h, w = vt.input_size
    fh, fw = vt.feat_size
    dy, dx = vt.y.size, vt.x.size

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    with torch.no_grad():
        imgs = full((b * n, 3, h, w), 1.0)
        _show("img_encoder", lambda: model._encode(imgs), args, dev)
        geom = _tensors(_key_frame(cfg, batch, GEOM_KEYS), dev, dt)
        feat = full((b, n, vt.in_channels, fh, fw), 0.01)
        cv = (full((b * n, vt.D, 4 * fh, 4 * fw), 1.0 / vt.D)
              if cfg.stereo else None)
        _show("view_transform",
              lambda: model.img_view_transformer(feat, geom, None, cv),
              args, dev)
        # the grids of every fused frame, concatenated on channels
        c_bev = vt.out_channels * (cfg.num_frames - (1 if cfg.stereo else 0))
        bev = full((b, c_bev, dy, dx), 0.01)

        def bev_encoder():
            x = model.img_bev_encoder_backbone(bev)
            if cfg.bev_encoder == "custom_resnet":
                x = model.img_bev_encoder_neck(x)
            return x
        _show("bev_encoder", bev_encoder, args, dev)
        for i, slab in enumerate(vt.slab_sizes):
            unet = getattr(model, f"img_voxel_encoder{i}")
            x = full((b, slab * c_bev, dy, dx), 0.01)
            _show(f"voxel_encoder{i} (unet {slab * c_bev}->"
                  f"{cfg.voxel_encoder_out[i]})",
                  lambda unet=unet, x=x: unet(x), args, dev)


def run_train(args, cfg, dt, dev, batch) -> None:
    """The whole train step (``train.train_step``: forward in train mode,
    losses, backward, clip, AdamW, EMA) on one synthetic batch with GT:
    bf16 mixed precision by default, as the JAX CLI trains (the forward in
    bf16 over fp32 weights), ``--fp32`` the fp32 step.  It prints ms/step
    and samples/s, the peak device memory, the last step's losses, and the
    device-busy time of a traced step with its top kernels; no MFU: the
    port has no FLOP count of the train step.
    ``--pool-plan`` ships a plan built once (single-frame presets: a
    temporal model pools each frame with its own geometry)."""
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.profiling import (kernel_launches, span, top_ops,
                                         trace_device)
    from dhd_tpu_torch.train import AdamWSchedule, ModelEMA, train_step
    tbatch = {k: torch.as_tensor(v, device=dev)
              for k, v in synthetic_batch(cfg, args.batch_size, seed=0,
                                          with_gt=True).items()}
    if args.pool_plan:
        if cfg.temporal:
            raise SystemExit("--pool-plan: single-frame presets only "
                             "(temporal training pools each frame with "
                             "its own geometry)")
        from dhd_tpu_torch.models import build_batch_pool_plan
        tbatch["pool_plan"] = build_batch_pool_plan(cfg, tbatch, device=dev)
        print("train batch ships a precomputed pool plan")
    model = _model(cfg, torch.float32, dev)
    optimizer = AdamWSchedule(model.parameters(), cfg.optim,
                              steps_per_epoch=1000)
    ema = ModelEMA(model, cfg.optim.ema_init_updates, cfg.optim.ema_decay)
    gen = torch.Generator(device=dev).manual_seed(1)
    last = {}
    precision = "bf16 mixed precision" if args.bf16 else "fp32"

    def step():
        last.update(train_step(model, optimizer, ema, tbatch, gen,
                               compute_dtype=dt))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernel_launches()
    s = timed_s(step, args.iters, dev)
    per_step = {k: (v - before[k]) / (args.iters + 1)
                for k, v in kernel_launches().items()}
    tf32 = (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
            f"cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}"
            if dev.type == "cuda" else "cpu")
    print(f"{args.preset} train step: {s * 1e3:.2f} ms/iter = "
          f"{args.batch_size / s:.2f} samples/s ({precision}, "
          f"B={args.batch_size}; {tf32})")
    print("peak memory: " + (
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"
        if dev.type == "cuda" else "not measured (no device)"))
    print("losses: " + " ".join(f"{k}={float(v):.4f}"
                                for k, v in sorted(last.items())))
    launched = ", ".join(f"{k} {v:g}" for k, v in per_step.items() if v)
    print(f"kernel launches a step: {launched or 'none'}"
          + ("" if dev.type == "cuda" else " (the CPU runs the plain "
             "versions)"))

    def run():
        with span("train_step"):
            step()
    prof = trace_device(run, dev, collapse=not args.profile_detail)
    busy = sum(prof["ops"].values())
    print(f"{prof['clock']} busy (one traced step): {busy:.2f} ms of "
          f"{s * 1e3:.2f} ms/step" + (
              f", idle share {1 - busy / (s * 1e3):.3f}"
              if prof["clock"] == "device" else ""))
    print(f"top kernels by {prof['clock']} time:")
    for name, ms, cnt in top_ops(prof, args.profile_ops):
        print(f"  {ms:10.3f} ms  x{cnt:<5d} {name}")


def run_exported(args, dev) -> None:
    """Time the deployment artifact as shipped, loaded fresh (the
    reference's benchmark_trt.py analogue): ``cli/export``'s program,
    with ``<artifact>.weights.pt`` where it exists, on its synthetic batch
    (the model's inputs on the device)."""
    from dhd_tpu_torch.cli.export import batch_inputs, load_program
    from dhd_tpu_torch.config import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.profiling import kernel_launches

    if not args.artifact:
        raise SystemExit("--what exported needs --artifact")
    fn, meta = load_program(args.artifact, dev)
    if torch.device(meta["device"]).type != dev.type:
        raise SystemExit(f"{args.artifact} was exported on "
                         f"{meta['device']}, not {dev}")
    bs = meta["batch_size"]
    batch = batch_inputs(synthetic_batch(get_config(meta["preset"]), bs,
                                         with_gt=False),
                         meta["inputs"], meta["device"])
    before = kernel_launches()
    s = timed_s(lambda: fn(batch), args.iters, dev)
    per_iter = {k: (v - before[k]) / (args.iters + 1)
                for k, v in kernel_launches().items()}
    print(f"{meta['preset']} exported artifact ({meta['dtype']}"
          f"{', int8' if meta['int8'] else ''}, "
          f"{'program + weights' if meta['split'] else 'baked weights'}): "
          f"{s * 1e3:.2f} ms/iter = {bs / s:.1f} samples/s")
    launched = ", ".join(f"{k} {v:g}" for k, v in per_iter.items() if v)
    print(f"kernel launches an iteration: {launched or 'none'}"
          + ("" if dev.type == "cuda" else " (a CPU program holds the "
             "plain versions)"))


MODES = {"full": run_full, "stream": run_stream, "stages": run_stages,
         "flops": run_flops, "cv": run_cv, "pool": run_pool,
         "train": run_train, "exported": run_exported}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="dhd_s")
    p.add_argument("--what", default="full", choices=list(MODES))
    p.add_argument("--artifact", default=None,
                   help="--what exported: the program cli/export wrote")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--profile", action="store_true",
                   help="after timing, trace a few more calls with "
                        "torch.profiler and print the time per range and "
                        "the top kernels")
    p.add_argument("--profile-ops", type=int, default=25)
    p.add_argument("--profile-detail", action="store_true",
                   help="keep template arguments in the kernel names and "
                        "print each kernel's full signature")
    p.add_argument("--pool-plan", action="store_true",
                   help="--what train: ship a pool plan built once (the "
                        "kernel path with a cached plan)")
    p.add_argument("--device", default=None,
                   help="'cpu' runs every kernel's plain version on the "
                        "CPU; default: the GPU (raises without one)")
    args = p.parse_args(argv)

    from dhd_tpu_torch.config import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if args.what == "exported":
        run_exported(args, dev)
        return 0
    cfg = get_config(args.preset)
    dt = torch.bfloat16 if args.bf16 else torch.float32
    batch = synthetic_batch(cfg, args.batch_size, seed=0, with_gt=False)
    MODES[args.what](args, cfg, dt, dev, batch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
