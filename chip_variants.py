#!/usr/bin/env python3
"""Time variants of the bf16 window-attention kernel (B4) on one GPU: each
variant is ``dhd_tpu_torch/csrc/window_attention.cu`` with a line edited,
built by nvcc into ``build/variants/`` and called through ctypes at DHD-L's
four Swin-B stage shapes (shifted and unshifted).

    python3 chip_variants.py [--variants base,nomask,bias2] [--repeat 2]

Variants, which ask what the shifted blocks' mask loads cost:

- ``base``: the source as it is, held within 4 bf16 ulps of the output's
  peak of ``window_attention_plain``;
- ``nomask``: no mask loads (timing only: its output is wrong);
- ``bias2``: the bias rows loaded and added a second time where the mask
  would be (the same loads as a shifted block, all L1 hits; timing only).

Prints the card, ptxas's report of each variant's ``<32, 9>``
instantiation, then one line per shape: each variant's device ms
(``chip_smoke.time_ms``).
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
VARIANTS = {
    "base": [],
    "nomask": [(MASK_ADD, "")],
    "bias2": [(MASK_ADD, MASK_ADD.replace("mask_w + o", "bias_h + o"))],
}
TIMING_ONLY = {"nomask", "bias2"}


def build(names):
    """nvcc for each variant, all at once; the ctypes entry of each."""
    from dhd_tpu_torch.ops import cuda_build
    from dhd_tpu_torch.ops.window_attention import _ARGTYPES

    src = (cuda_build.CSRC / "window_attention.cu").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source has changed")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        import chip_smoke
        print(f"{name}: " + "; ".join(
            ln for ln in chip_smoke.short_ptxas(
                chip_smoke.ptxas_lines(log), "window_attention_mma_kernel")
            if ln.startswith("<32, 9>")), flush=True)
        fn = ctypes.CDLL(str(out / f"{name}.so")).window_attention_bf16
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.nn.swin import _shift_attn_mask
    from dhd_tpu_torch.ops import window_attention_plain
    from dhd_tpu_torch.ops.window_attention import attention_scale

    names = args.variants.split(",")
    print(chip_smoke.smi_name_power(), flush=True)
    fns = build(names)
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
