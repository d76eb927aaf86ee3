#!/usr/bin/env python3
"""Time variants of a kernel on one GPU: each variant is the kernel's
source under ``dhd_tpu_torch/csrc/`` with a line edited, built by nvcc into
``build/variants/`` and called through ctypes.

    python3 chip_variants.py [--variants base,nomask,bias2] [--repeat 2]
    python3 chip_variants.py --kernel cv [--variants base,sametap]
    python3 chip_variants.py --kernel segsum [--variants base,nofix,nostore]
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
(``chip_smoke.time_ms``).

``--kernel cv``: the stereo cost-volume kernel (B3), ``cost_volume.cu``,
at DHD-M and DHD-L (phases 5 and 11's inputs), with ptxas's report of its
bf16 instantiations.  ``base`` is held to phase 5's bar against
``cv_cost_plain``; ``sametap`` gathers every sample's taps from the map's
first pixel (all L1 hits): what the kernel costs without its tap traffic
(timing only).

``--kernel segsum``: the sorted segment-sum (B2), ``segment_sum.cu``, at
phase 14's cases.  ``base`` is held to phase 14's bar against
``sorted_segment_sum_plain``; ``nofix`` skips the second pass and
``nostore`` stores no output rows (both timing only): what each costs.

``--kernel pool``: the fused MGHS pooling (B1), ``mghs_pool.cu``, at the
inputs of phases 2, 6 and 11 (DHD-S, DHD-M, DHD-L) and the hot pillar
(``chip_smoke.pool_case``), with ptxas's report of its first pass.
``base`` is held to phase 2's bar (one bf16 ulp, or at DHD-L one ulp
plus 2^-20 of the terms) against ``mghs_pool_plan_plain``;
``nopoints`` skips the point walk and writes only zero rows: the write
floor; ``nostore`` walks the points and stores nothing in the first pass
(both timing only); ``rows2x`` keeps twice as many feature rows in
flight.  ``--pieces`` also times ``base`` with the plan's schedule rebuilt
for each piece size (the most points a warp sums), ``--lanes`` at each
forced (channels a lane)x(lanes a point), both held to the bar.  Each
line ends with ``zero_``: ``Tensor.zero_`` of the same vox and bev, the
card's own rate of writing those bytes.
"""
import argparse
import ctypes
import pathlib
import subprocess
import sys

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
}


def build(kernel, names):
    """nvcc for each variant of `kernel`, all at once; the library of each."""
    import chip_smoke
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
                ln for ln in chip_smoke.short_ptxas(
                    chip_smoke.ptxas_lines(log), ptxas[0])
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
    """B3's variants at phases 5 and 11's inputs (DHD-M and DHD-L)."""
    import chip_smoke
    from dhd_tpu_torch.ops import cv_cost_plain
    from dhd_tpu_torch.ops.cost_volume_cuda import _ARGTYPES

    fns = entries(build("cv", names), "stereo_cost_bf16", _ARGTYPES)
    dev = torch.device("cuda")
    cases = {preset: chip_smoke.cv_inputs(dev, preset)
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
                chip_smoke.check(run() == 0, f"{name}: launch failed")
                torch.cuda.synchronize()
                got = torch.softmax(-cost, 1)
                chip_smoke.check(name in TIMING_ONLY or bool((
                    (got - want).abs() <= chip_smoke.CV_ATOL
                    + chip_smoke.CV_RTOL * want).all()),
                    f"{name} at {preset}: probabilities differ")
                row.append(f"{name} {chip_smoke.time_ms(run):.4f}")
            print(f"{preset} ({bn}, {d}, {hs}, {ws}) x C={prev.shape[-1]}: "
                  + ", ".join(row), flush=True)
    return 0


def main_segsum(names, repeat) -> int:
    """B2's variants at phase 14's cases, the ids sorted, each held to
    phase 14's bar against the plain version (but the timing-only
    ones)."""
    import numpy as np

    import chip_smoke
    from dhd_tpu_torch.ops.segment_sum import (_ARGTYPES, _NAME,
                                               channels_per_lane,
                                               sorted_segment_sum_plain)

    libs = build("segsum", names)
    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    cases = []
    for label, p, c, v, dt, out_dt, layout in chip_smoke.segsum_cases():
        seg = torch.from_numpy(chip_smoke.segsum_ids(rng, p, v, layout)
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
                chip_smoke.check(run() == 0, f"{name}: launch failed")
                torch.cuda.synchronize()
                chip_smoke.check(
                    name in TIMING_ONLY or bool(
                        ((out.float() - want).abs() <= ulp
                         + 2.0 ** -20 * terms).all()),
                    f"{name} at {label}: sums differ")
                row.append(f"{name} {chip_smoke.time_ms(run):.4f}")
            print(f"{label} (P={p}, C={c}, V={v}): " + ", ".join(row),
                  flush=True)
    return 0


def main_pool(names, repeat, pieces, lanes) -> int:
    """B1's variants at phases 2, 6 and 11's inputs and the hot pillar;
    then ``base`` with the plan's schedule rebuilt for each piece size in
    ``pieces`` and at each (channels a lane, lanes a point) in ``lanes``."""
    import dataclasses

    import chip_smoke
    from dhd_tpu_torch.ops.mghs_pool_cuda import (_ARGTYPES, _FN,
                                                  lanes_per_point,
                                                  mghs_pool_plan_plain,
                                                  pool_schedule_plain)

    libs = build("pool", names)
    dev = torch.device("cuda")
    cases = {preset: chip_smoke.pool_case(dev, preset)
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
                chip_smoke.check(run() == 0, f"{name}: launch failed")
                torch.cuda.synchronize()
                if name not in TIMING_ONLY:
                    ulps = max(chip_smoke.bf16_ulp_diff(bev, want[0]),
                               chip_smoke.bf16_ulp_diff(vox, want[1]))
                    frac = max(chip_smoke.sum_error_share(bev, want[0],
                                                          terms[0]),
                               chip_smoke.sum_error_share(vox, want[1],
                                                          terms[1]))
                    chip_smoke.check(
                        ulps <= chip_smoke.POOL_ULP_TOL
                        or (preset == "dhd_l" and frac <= 1),
                        f"{name} at {preset}: {ulps} ulps, {frac:.3f}")
                row.append(f"{name} {chip_smoke.time_ms(run):.4f}")
            row.append("zero_ {:.4f}".format(chip_smoke.time_ms(
                lambda: (vox.zero_(), bev.zero_()))))
            print(f"{preset} (P={plan.dix_s.numel()}, busiest pillar "
                  f"{chip_smoke.pillar_histogram(plan)['max']}, "
                  f"{int((plan.tasks[:, 0] < b * dy * dx).sum())} tasks): "
                  + ", ".join(row), flush=True)
            del want, terms
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("attn", "cv", "segsum", "pool"),
                    default="attn")
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
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    print(chip_smoke.smi_name_power(), flush=True)
    names = (args.variants or ",".join(VARIANTS[args.kernel])).split(",")
    if args.kernel == "cv":
        return main_cv(names, args.repeat)
    if args.kernel == "segsum":
        return main_segsum(names, args.repeat)
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
                chip_smoke.swin_stage_shapes(cfg)):
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
                    chip_smoke.check(run() == 0, f"{name}: launch failed")
                    torch.cuda.synchronize()
                    ulps = (float((out.float() - want.float()).abs().max())
                            / chip_smoke.bf16_ulp_at(want))
                    chip_smoke.check(name in TIMING_ONLY or ulps <= 4,
                                     f"{name}: {ulps:.2f} ulps")
                    row.append(f"{name} {chip_smoke.time_ms(run):.4f}")
                print(f"stage{i} {'shifted' if shifted else 'unshifted'} "
                      f"(W={w}, heads={heads}): " + ", ".join(row),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
