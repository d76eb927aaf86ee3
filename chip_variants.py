#!/usr/bin/env python3
"""Time variants of a kernel on one GPU: each variant is the kernel's
source under ``dhd_tpu_torch/csrc/`` with a line edited, built by nvcc into
``build/variants/`` and called through ctypes.

    python3 chip_variants.py [--variants base,nomask,bias2] [--repeat 2]
    python3 chip_variants.py --kernel cv [--variants base,sametap]
    python3 chip_variants.py --kernel segsum [--variants base,nofix,nostore]
    python3 chip_variants.py --kernel ln
    python3 chip_variants.py --kernel pool [--variants base,nopoints,nostore]
        [--pieces 64,256] [--lanes 2x32]

``--kernel attn`` (the default): the bf16 window-attention kernel (B4),
``window_attention.cu``, at DHD-L's four Swin-B stage shapes (shifted and
unshifted).  Its variants ask what the shifted blocks' mask loads cost:

- ``base``: the source as it is, held within 4 bf16 ulps of the output's
  peak of ``window_attention_plain``;
- ``nomask``: no mask loads (timing only: its output is wrong);
- ``bias2``: the bias rows loaded and added a second time where the mask
  would be (the same loads as a shifted block, all L1 hits; timing only).

Prints the card, ptxas's report of each variant's ``<32, 9>``
instantiation, then one line per shape: each variant's device ms
(:func:`time_ms`).

``--kernel cv``: the stereo cost-volume kernel (B3), ``cost_volume.cu``,
at DHD-M and DHD-L (:func:`cv_inputs`), with ptxas's report of its bf16
instantiations.  ``base`` is held against ``cv_cost_plain`` to the
tolerance the TPU kernel held against XLA (``CV_ATOL``, ``CV_RTOL``, on
the probabilities); ``sametap`` gathers every sample's taps from the
map's first pixel (all L1 hits): what the kernel costs without its tap
traffic (timing only).

``--kernel segsum``: the sorted segment-sum (B2), ``segment_sum.cu``, at
:func:`segsum_cases`.  ``base`` is held against
``sorted_segment_sum_plain`` (one bf16 ulp plus 2^-20 of the summed
|terms|); ``nofix`` skips the second pass and ``nostore`` stores no
output rows (both timing only): what each costs.

``--kernel ln``: the LayerNorm (B5), ``layer_norm.cu``, at DHD-L's four
Swin-B stages (six images, bf16): its plain launch over a stage's tokens
and a block's two fused launches (norm1 in window order, the pad and the
shift inside; the window reverse, the attention residual and norm2),
unshifted and shifted, each beside its byte bound (the plain launch x
and y, the window launch x and the window tensor, the residual launch x,
the attention output's rows, the sum and the norm, once each) and the
chain's time (B5 with ``F.pad`` and the gather; the gather, the add and
B5); ``base`` held bit for bit against the chain; ptxas's report of
every instantiation.

``--kernel pool``: the fused MGHS pooling (B1), ``mghs_pool.cu``, at the
served plans of DHD-S, DHD-M and DHD-L and the hot pillar
(:func:`pool_case`), with ptxas's report of its first pass.  ``base`` is
held against ``mghs_pool_plan_plain`` (one bf16 ulp, or at DHD-L one ulp
plus 2^-20 of the terms);
``nopoints`` skips the point walk and writes only zero rows: the write
floor; ``nostore`` walks the points and stores nothing in the first pass
(both timing only); ``rows2x`` keeps twice as many feature rows in
flight.  ``--pieces`` also times ``base`` with the plan's schedule rebuilt
for each piece size (the most points a warp sums), ``--lanes`` at each
forced (channels a lane)x(lanes a point), both held to the bar.  Each
line ends with ``zero_``: ``Tensor.zero_`` of the same vox and bev, the
card's own rate of writing those bytes.

The cases' inputs, the bars and the timers here are shared with the
port's ``cuda``-marked tests (``tests/test_torch_cuda.py``), which hold
the kernels at the same inputs.
"""
import argparse
import ctypes
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
MASK_ADD = """    if (mask_w != nullptr)
      add_rows<NK>(s, mask_w + o0, mask_w + o1, t, nk, N, vec != 0);"""
SEG_STORE = "store<TO, VEC>(out + static_cast<size_t>(cur) * C + c, acc);"
POOL_WALK = "for (int base = p0; base < p1; base += 32) {"
VARIANTS = {  # kernel -> variant -> exact source edits
    "attn": {
        "base": [],
        "nomask": [(MASK_ADD, "")],
        "bias2": [(MASK_ADD, MASK_ADD.replace("mask_w + o", "bias_h + o"))],
    },
    "cv": {
        "base": [],
        "sametap": [("const T* r0 = src + sm.off;", "const T* r0 = src;")],
    },
    "segsum": {
        "base": [],
        "nofix": [("cfg.numAttrs = 1;",
                   "cfg.numAttrs = 1;\n  if (C > 0) return 0;")],
        "nostore": [(SEG_STORE, "if (acc[0] == 1234.5f) " + SEG_STORE)],
    },
    "ln": {
        "base": [],
    },
    "pool": {
        "base": [],
        "nopoints": [(POOL_WALK, POOL_WALK.replace("< p1", "< p0"))],
        "rows2x": [("kRowsWant = 8 / VEC;", "kRowsWant = 16 / VEC;")],
        "nostore": [("if (active && grp == 0) {",
                     "if (active && grp == 0 && acc[0] == 1234.5f) {"),
                    ("if (!active) continue;", "continue;")],
    },
}
TIMING_ONLY = {"nomask", "bias2", "sametap", "nofix", "nostore", "nopoints"}
# kernel -> source, and the ptxas lines printed (kernel, instantiation)
SOURCES = {
    "attn": ("window_attention.cu", ("window_attention_mma_kernel", "<32, 9>")),
    "cv": ("cost_volume.cu", ("cost_volume_kernel", "<13__nv_bfloat16")),
    "segsum": ("segment_sum.cu", None),
    "pool": ("mghs_pool.cu", ("mghs_pool_kernel", "<")),
    "ln": ("layer_norm.cu", ("layer_norm_kernel", "<")),
}


SLEEP_CYCLES = 2_000_000    # ~1 ms of device clock ahead of each timed call
POOL_ULP_TOL = 1            # B1 vs plain in bf16: fp32 sum order only
CV_ATOL, CV_RTOL = 2e-5, 1e-4   # B3 vs plain probabilities: the tolerance
#                                 the TPU kernel held against XLA
TERM_TOL = 2.0 ** -20       # per element: 8 fp32 ulps of the magnitudes of
#                             the terms it is summed from (fp32 sum order)
SEGSUM_IDS = 1.5            # B2's ids uniform over [0, 1.5 V), as the CLI


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def smi_name_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
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


def bf16_ulp_at(x: torch.Tensor) -> float:
    """One bf16 ulp at the peak magnitude of ``x``."""
    return 2.0 ** (float(torch.floor(torch.log2(x.float().abs().max()))) - 7)


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


def window_norm_chain(x, weight, bias, eps, hw, ws, shift):
    """What ``swin_window_norm_cuda`` stands for, as the Swin block's chain
    runs it (``nn/swin.py:ShiftWindowMSA.forward``): B5 over x's rows,
    ``F.pad`` to multiples of ``ws``, then the shift and the window
    partition as one row gather; (B * nW * ws * ws, C)."""
    from dhd_tpu_torch.nn.swin import _device_perms
    from dhd_tpu_torch.ops import fused_layer_norm_cuda

    h, w = hw
    b, _, c = x.shape
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    y = fused_layer_norm_cuda(x, weight, bias, eps).reshape(b, h, w, c)
    y = torch.nn.functional.pad(y, (0, 0, 0, wp - w, 0, hp - h))
    fwd, _ = _device_perms(hp, wp, h, w, ws, shift, x.device)
    return y.reshape(b, hp * wp, c).index_select(1, fwd).reshape(-1, c)


def residual_norm_chain(x, wins, weight, bias, eps, hw, ws, shift):
    """What ``swin_residual_norm_cuda`` stands for, as the block's chain
    runs it: the window reverse, the unshift and the crop as one row
    gather, the residual add, and B5: (x + attn, norm2(x + attn))."""
    from dhd_tpu_torch.nn.swin import _device_perms
    from dhd_tpu_torch.ops import fused_layer_norm_cuda

    h, w = hw
    b, _, c = x.shape
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    _, inv = _device_perms(hp, wp, h, w, ws, shift, x.device)
    s = x + wins.reshape(b, -1, c).index_select(1, inv)
    return s, fused_layer_norm_cuda(s, weight, bias, eps)


def bits_apart(a, b) -> int:
    """Elements of a and b whose bits differ, NaN where NaN counting as
    equal (a NaN's payload aside); raises where the shapes or dtypes
    differ."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{a.dtype} {tuple(a.shape)} against {b.dtype} {tuple(b.shape)}")
    nan = torch.isnan(a)
    ints = torch.int16 if a.element_size() == 2 else torch.int32
    return int((nan != torch.isnan(b)).sum()) + int(
        (a.view(ints)[~nan] != b.view(ints)[~nan]).sum())


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


def pillar_histogram(plan) -> dict:
    """Points per non-empty pillar: mean, p99, max, and the pillars of more
    than 256 points (one warp's share of B1)."""
    n = (plan.starts[1:] - plan.starts[:-1]).float()
    n = n[n > 0]
    return {"pillars": int(n.numel()), "mean": float(n.mean()),
            "p99": float(torch.quantile(n, 0.99)), "max": int(n.max()),
            "over_256": int((n > 256).sum())}


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


def build(kernel, names):
    """nvcc for each variant of `kernel`, all at once; the library of each."""
    from dhd_tpu_torch.ops import cuda_build

    source, ptxas = SOURCES[kernel]
    src = (cuda_build.CSRC / source).read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[kernel][name]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source has changed")
            text = text.replace(old, new)
        (out / f"{kernel}_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
             str(out / f"{kernel}_{name}.so"), str(out / f"{kernel}_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        if ptxas is not None:
            print(f"{name}: " + "; ".join(
                ln for ln in short_ptxas(
                    ptxas_lines(log), ptxas[0])
                if ln.startswith(ptxas[1])), flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{kernel}_{name}.so"))
    return libs


def entries(libs, symbol, argtypes):
    """Each library's ctypes entry `symbol`."""
    fns = {}
    for name, lib in libs.items():
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def main_cv(names, repeat) -> int:
    """B3's variants at :func:`cv_inputs` of DHD-M and DHD-L."""
    from dhd_tpu_torch.ops import cv_cost_plain
    from dhd_tpu_torch.ops.cost_volume_cuda import _ARGTYPES

    fns = entries(build("cv", names), "stereo_cost_bf16", _ARGTYPES)
    dev = torch.device("cuda")
    cases = {preset: cv_inputs(dev, preset)
             for preset in ("dhd_m", "dhd_l")}
    for _ in range(repeat):
        for preset, (prev, curr, uf, vf, bias) in cases.items():
            want = torch.softmax(-cv_cost_plain(prev, curr, uf, vf, bias), 1)
            cost = torch.empty(uf.shape, dtype=torch.float32, device=dev)
            bn, d, hs, ws = uf.shape
            row = []
            for name, fn in fns.items():
                def run(fn=fn):
                    return fn(prev.data_ptr(), curr.data_ptr(), uf.data_ptr(),
                              vf.data_ptr(), cost.data_ptr(), bn, d, hs, ws,
                              prev.shape[-1], bias,
                              torch.cuda.current_stream().cuda_stream)
                check(run() == 0, f"{name}: launch failed")
                torch.cuda.synchronize()
                got = torch.softmax(-cost, 1)
                check(name in TIMING_ONLY or bool((
                    (got - want).abs() <= CV_ATOL
                    + CV_RTOL * want).all()),
                    f"{name} at {preset}: probabilities differ")
                row.append(f"{name} {time_ms(run):.4f}")
            print(f"{preset} ({bn}, {d}, {hs}, {ws}) x C={prev.shape[-1]}: "
                  + ", ".join(row), flush=True)
    return 0


def main_segsum(names, repeat) -> int:
    """B2's variants at :func:`segsum_cases`, the ids sorted, each held
    against the plain version (but the timing-only ones)."""
    from dhd_tpu_torch.ops.segment_sum import (_ARGTYPES, _NAME,
                                               channels_per_lane,
                                               sorted_segment_sum_plain)

    libs = build("segsum", names)
    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    cases = []
    for label, p, c, v, dt, out_dt, layout in segsum_cases():
        seg = torch.from_numpy(segsum_ids(rng, p, v, layout)
                               ).to(dev)
        seg_s, order = torch.sort(seg, stable=True)
        vals = torch.from_numpy(rng.normal(0, 1, (p, c)).astype(
            np.float32)).to(dev, dt)[order].contiguous()
        cases.append((label, vals, seg_s, v, out_dt))
    for _ in range(repeat):
        for label, vals, seg_s, v, out_dt in cases:
            p, c = vals.shape
            want = sorted_segment_sum_plain(vals, seg_s, v, out_dt).float()
            terms = sorted_segment_sum_plain(vals.abs(), seg_s, v)
            ulp = (torch.where(want == 0, 0.0, torch.exp2(
                torch.floor(torch.log2(want.abs())) - 7))
                if out_dt == torch.bfloat16 else 0.0)
            out = torch.empty((v, c), dtype=out_dt, device=dev)
            row = []
            for name, lib in libs.items():
                fn = getattr(lib, f"segment_sum_{_NAME[vals.dtype]}_"
                                  f"{_NAME[out_dt]}")
                fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
                vec = channels_per_lane(vals)
                scratch = torch.empty(
                    -(-(p + v) // lib.segment_sum_items()) * (2 * c + 2),
                    dtype=torch.float32, device=dev)

                def run(fn=fn, vec=vec, scratch=scratch):
                    return fn(vals.data_ptr(), seg_s.data_ptr(), None,
                              out.data_ptr(), scratch.data_ptr(), p, c, v,
                              vec, torch.cuda.current_stream().cuda_stream)
                out.fill_(float("nan"))
                check(run() == 0, f"{name}: launch failed")
                torch.cuda.synchronize()
                check(
                    name in TIMING_ONLY or bool(
                        ((out.float() - want).abs() <= ulp
                         + 2.0 ** -20 * terms).all()),
                    f"{name} at {label}: sums differ")
                row.append(f"{name} {time_ms(run):.4f}")
            print(f"{label} (P={p}, C={c}, V={v}): " + ", ".join(row),
                  flush=True)
    return 0


def main_pool(names, repeat, pieces, lanes) -> int:
    """B1's variants at :func:`pool_case` of DHD-S, DHD-M, DHD-L and the
    hot pillar;
    then ``base`` with the plan's schedule rebuilt for each piece size in
    ``pieces`` and at each (channels a lane, lanes a point) in ``lanes``."""
    import dataclasses

    from dhd_tpu_torch.ops.mghs_pool_cuda import (_ARGTYPES, _FN,
                                                  lanes_per_point,
                                                  mghs_pool_plan_plain,
                                                  pool_schedule_plain)

    libs = build("pool", names)
    dev = torch.device("cuda")
    cases = {preset: pool_case(dev, preset)
             for preset in ("dhd_s", "dhd_m", "dhd_l", "hot")}
    for _ in range(repeat):
        for preset, (cfg, plan, depth, feat, band_mask) in cases.items():
            want = mghs_pool_plan_plain(depth, feat, band_mask, plan)
            terms = mghs_pool_plan_plain(depth, feat.abs(), band_mask, plan)
            b, dy, dx, dz = plan.grid
            c = feat.shape[-1]
            bev = torch.empty((b, dy, dx, c), dtype=feat.dtype, device=dev)
            vox = torch.empty((b, dy, dx, dz, c), dtype=feat.dtype,
                              device=dev)
            row = []
            runs = [(name, fn, plan) for name, fn in entries(
                libs, _FN[feat.dtype], _ARGTYPES).items()]
            for piece in pieces:
                tasks, splits, n_slots = pool_schedule_plain(
                    plan.starts, plan.dix_s.numel(), piece)
                runs.append((f"piece{piece}", runs[0][1], dataclasses.replace(
                    plan, tasks=tasks, splits=splits, n_slots=n_slots)))
            runs = [(name, fn, sched, lanes_per_point(feat))
                    for name, fn, sched in runs] + [
                (f"{v}x{lp}", runs[0][1], plan, (v, lp)) for v, lp in lanes]
            for name, fn, sched, vl in runs:
                scratch = torch.empty(sched.n_slots * (dz + 1) * c,
                                      dtype=torch.float32, device=dev)
                def run(fn=fn, sp=sched, scratch=scratch, vl=vl):
                    return fn(depth.data_ptr(), feat.data_ptr(),
                              band_mask.data_ptr(), sp.dix_s.data_ptr(),
                              sp.z_s.data_ptr(), sp.tasks.data_ptr(),
                              sp.splits.data_ptr(),
                              scratch.data_ptr(), bev.data_ptr(),
                              vox.data_ptr(), sp.tasks.shape[0],
                              sp.splits.shape[0], b * dy * dx, c,
                              depth.shape[-1], dz, *sp.band_edges,
                              *vl, torch.cuda.current_stream().cuda_stream)
                check(run() == 0, f"{name}: launch failed")
                torch.cuda.synchronize()
                if name not in TIMING_ONLY:
                    ulps = max(bf16_ulp_diff(bev, want[0]),
                               bf16_ulp_diff(vox, want[1]))
                    frac = max(sum_error_share(bev, want[0],
                                                          terms[0]),
                               sum_error_share(vox, want[1],
                                                          terms[1]))
                    check(
                        ulps <= POOL_ULP_TOL
                        or (preset == "dhd_l" and frac <= 1),
                        f"{name} at {preset}: {ulps} ulps, {frac:.3f}")
                row.append(f"{name} {time_ms(run):.4f}")
            row.append("zero_ {:.4f}".format(time_ms(
                lambda: (vox.zero_(), bev.zero_()))))
            print(f"{preset} (P={plan.dix_s.numel()}, busiest pillar "
                  f"{pillar_histogram(plan)['max']}, "
                  f"{int((plan.tasks[:, 0] < b * dy * dx).sum())} tasks): "
                  + ", ".join(row), flush=True)
            del want, terms
    return 0


def main_ln(names, repeat) -> int:
    """B5 at DHD-L's Swin-B stages (B=1: six images, bf16): its plain
    launch over a stage's tokens, and a block's two fused launches
    (window order with the pad and shift; window reverse, residual and
    norm2), each held bit for bit against the chain it stands for
    (:func:`window_norm_chain`, :func:`residual_norm_chain`) and timed
    beside its byte bound and the chain's time."""
    from bench_port.bounds import HBM_BYTES_PER_S
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.ops.layer_norm import (_ARGTYPES, _RESIDUAL_ARGTYPES,
                                              _WINDOW_ARGTYPES)

    libs = build("ln", names)
    plain = entries(libs, "layer_norm_bf16", _ARGTYPES)
    window = entries(libs, "layer_norm_windows_bf16", _WINDOW_ARGTYPES)
    residual = entries(libs, "layer_norm_residual_bf16", _RESIDUAL_ARGTYPES)
    cfg = get_config("dhd_l")
    dev, bf16, ws, imgs = (torch.device("cuda"), torch.bfloat16,
                           cfg.swin_window, cfg.num_cams)
    g = torch.Generator(device=dev).manual_seed(19)

    def ms_bound(nbytes):
        return f"(bound {1e3 * nbytes / HBM_BYTES_PER_S:.4f})"
    for _ in range(repeat):
        for i, (h, w, hp, wp, c, _, _) in enumerate(swin_stage_shapes(cfg)):
            x = torch.randn((imgs, h * w, c), generator=g,
                            device=dev).to(bf16)
            wins = torch.randn((imgs * hp * wp, c), generator=g,
                               device=dev).to(bf16)
            wt = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
            bs = 0.3 * torch.randn(c, generator=g, device=dev)
            u, aff = x.numel() * 2, 8 * c
            y, s2, y2 = (torch.empty_like(x) for _ in range(3))
            yw = torch.empty_like(wins)
            stream = torch.cuda.current_stream().cuda_stream
            for shift in (0, ws // 2):
                args = (1e-6, (h, w), ws, shift)
                want_w = window_norm_chain(x, wt, bs, *args)
                want_s, want_y = residual_norm_chain(x, wins, wt, bs, *args)
                chain_w = time_ms(
                    lambda: window_norm_chain(x, wt, bs, *args))
                chain_r = time_ms(
                    lambda: residual_norm_chain(x, wins, wt, bs, *args))
                row = [f"chain window {chain_w:.4f}, residual {chain_r:.4f}"]
                for name in names:
                    runs = (
                        lambda: plain[name](
                            x.data_ptr(), wt.data_ptr(), bs.data_ptr(),
                            y.data_ptr(), imgs * h * w, c, 1e-6, stream),
                        lambda: window[name](
                            x.data_ptr(), wt.data_ptr(), bs.data_ptr(),
                            yw.data_ptr(), imgs, c, 1e-6, h, w, ws, shift,
                            stream),
                        lambda: residual[name](
                            x.data_ptr(), wins.data_ptr(), wt.data_ptr(),
                            bs.data_ptr(), s2.data_ptr(), y2.data_ptr(),
                            imgs, c, 1e-6, h, w, ws, shift, stream))
                    check(all(run() == 0 for run in runs),
                          f"{name}: launch failed")
                    torch.cuda.synchronize()
                    apart = (bits_apart(yw, want_w) + bits_apart(s2, want_s)
                             + bits_apart(y2, want_y))
                    check(name in TIMING_ONLY or apart == 0,
                          f"{name}: {apart} elements off the chain")
                    row.append(
                        f"{name} B5 {time_ms(runs[0]):.4f} "
                        f"{ms_bound(2 * u + aff)}, window "
                        f"{time_ms(runs[1]):.4f} "
                        f"{ms_bound(u + yw.numel() * 2 + aff)}, residual "
                        f"{time_ms(runs[2]):.4f} {ms_bound(4 * u + aff)}")
                print(f"stage{i} {imgs}x{h}x{w}x{c} "
                      f"{'shifted' if shift else 'unshifted'}: "
                      + "; ".join(row), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("attn", "cv", "segsum", "pool",
                                         "ln"), default="attn")
    ap.add_argument("--variants", default=None)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--lanes", default="",
                    help="pool: also base at these channels x lanes, 2x32")
    ap.add_argument("--pieces", default="",
                    help="pool: piece sizes to rebuild the schedule with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device; nothing run", file=sys.stderr)
        return 1
    print(smi_name_power(), flush=True)
    names = (args.variants or ",".join(VARIANTS[args.kernel])).split(",")
    if args.kernel == "cv":
        return main_cv(names, args.repeat)
    if args.kernel == "segsum":
        return main_segsum(names, args.repeat)
    if args.kernel == "ln":
        return main_ln(names, args.repeat)
    if args.kernel == "pool":
        return main_pool(names, args.repeat,
                         [int(x) for x in args.pieces.split(",") if x],
                         [tuple(int(y) for y in x.split("x"))
                          for x in args.lanes.split(",") if x])
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.nn.swin import _shift_attn_mask
    from dhd_tpu_torch.ops import window_attention_plain
    from dhd_tpu_torch.ops.window_attention import _ARGTYPES, attention_scale

    fns = entries(build("attn", names), "window_attention_bf16", _ARGTYPES)
    cfg = get_config("dhd_l")
    dev, bf16, n = torch.device("cuda"), torch.bfloat16, 144
    g = torch.Generator(device=dev).manual_seed(9)
    for _ in range(args.repeat):
        for i, (_, _, hp, wp, c, heads, _) in enumerate(
                swin_stage_shapes(cfg)):
            w = cfg.num_cams * (hp // 12) * (wp // 12)
            qkv = torch.randn((w, n, 3 * c), generator=g, device=dev).to(bf16)
            bias = torch.randn((heads, n, n), generator=g,
                               device=dev).to(bf16)
            for shifted in (False, True):
                mask = (torch.from_numpy(_shift_attn_mask(hp, wp, 12, 6))
                        .to(dev, bf16) if shifted else None)
                want = window_attention_plain(qkv, bias, mask, heads)
                out = torch.empty((w, n, c), dtype=bf16, device=dev)
                row = []
                for name, fn in fns.items():
                    def run(fn=fn):
                        return fn(qkv.data_ptr(), bias.data_ptr(),
                                  0 if mask is None else mask.data_ptr(),
                                  out.data_ptr(), w, n, c, heads,
                                  0 if mask is None else mask.shape[0],
                                  attention_scale(c // heads, bf16),
                                  torch.cuda.current_stream().cuda_stream)
                    check(run() == 0, f"{name}: launch failed")
                    torch.cuda.synchronize()
                    ulps = (float((out.float() - want.float()).abs().max())
                            / bf16_ulp_at(want))
                    check(name in TIMING_ONLY or ulps <= 4,
                                     f"{name}: {ulps:.2f} ulps")
                    row.append(f"{name} {time_ms(run):.4f}")
                print(f"stage{i} {'shifted' if shifted else 'unshifted'} "
                      f"(W={w}, heads={heads}): " + ", ".join(row),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
