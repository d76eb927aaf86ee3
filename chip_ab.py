#!/usr/bin/env python3
"""Run phases of chip_smoke.py against the ``dhd_tpu_torch`` package of
another checkout, to compare two trees on one card.

    python3 chip_ab.py DIR [WHAT ...]

DIR is the root of a checkout (for example a ``git archive`` of the parent
commit unpacked under ``build/``).  WHAT names the phases, by default
``stream``:

- ``stream``: DHD-M streaming (latency, device busy time, host syncs and
  the cost-volume stage's trace reading), phase 7;
- ``dhd_l``: DHD-L streaming, phase 12 (the backbone's stage ms);
- ``kernels``: window attention (B4) and LayerNorm (B5) against their plain
  versions and the library calls at DHD-L's shapes, phases 9 and 10;
- ``cv``: the stereo cost volume (B3) against its plain version at DHD-M
  and DHD-L, phases 5 and 11;
- ``segsum``: the sorted segment-sum (B2) against its plain version and
  ``torch.segment_reduce`` at its cases, phase 14;
- ``pool``: the fused MGHS pooling (B1) against its plain version at DHD-S,
  DHD-M and DHD-L (phases 2, 6 and 11) and at the hot pillar (phase 14);
- ``uncached``: the paths that build the pool plan in the call: DHD-S
  frames without a cached plan (phase 3's uncached reading: median
  frame, device busy time, host syncs), then the benchmark CLI
  (``dhd_tpu_torch.cli.benchmark.main``): ``--what pool`` at DHD-S and
  DHD-L (B1 with the plan built in the call, and with a cached one) and
  ``--what full`` at DHD-S (a whole frame).

Run it once per tree on one card, in the order parent, change, change,
parent.
"""
import collections
import importlib.util
import pathlib
import sys
import time

WHAT = ("stream", "dhd_l", "kernels", "cv", "segsum", "pool", "uncached")
# the CLI runs of ``uncached``
UNCACHED = (("--preset", "dhd_s", "--what", "pool", "--iters", "50"),
            ("--preset", "dhd_l", "--what", "pool", "--iters", "50"),
            ("--preset", "dhd_s", "--what", "full", "--iters", "200"))


def main() -> int:
    tree = pathlib.Path(sys.argv[1]).resolve()
    what = sys.argv[2:] or ["stream"]
    if any(w not in WHAT for w in what):
        print(f"chip_ab: WHAT must be among {WHAT}, got {what}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; nothing run", file=sys.stderr)
        return 1
    import dhd_tpu_torch
    from dhd_tpu_torch.ops import cuda_build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    logs = cuda_build.build(cuda_build.SOURCES)
    ptxas = {name: smoke.ptxas_lines(log) for name, log in logs.items()}
    print(f"package {pathlib.Path(dhd_tpu_torch.__file__).parent}; built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    dev, card = torch.device("cuda"), smoke.smi_name_power()
    kernels = collections.defaultdict(dict)
    for w in what:
        if w == "stream":
            smoke.phase_stream(dev, kernels, card)
        elif w == "dhd_l":
            smoke.phase_stream(dev, kernels, card, "dhd_l")
        elif w == "cv":
            print(card, flush=True)
            smoke.phase_cost_volume(dev, kernels, "dhd_m", ptxas)
            smoke.phase_cost_volume(dev, kernels, "dhd_l", ptxas)
        elif w == "segsum":
            print(card, flush=True)
            smoke.phase_segment_sum(dev, kernels, ptxas)
        elif w == "pool":
            print(card, flush=True)
            for preset in ("dhd_s", "dhd_m", "dhd_l", "hot"):
                smoke.phase_kernel(dev, kernels, preset, ptxas)
        elif w == "uncached":
            from dhd_tpu_torch.cli.benchmark import main as benchmark
            smoke.phase_serve_uncached(dev, card)
            for argv in UNCACHED:
                print(" ".join(argv), flush=True)
                smoke.check(benchmark(list(argv)) == 0, f"cli {argv} failed")
                torch.cuda.empty_cache()
        else:
            print(card, flush=True)
            smoke.phase_attention(dev, kernels, ptxas)
            smoke.phase_layer_norm(dev, kernels, ptxas)
    return 0


if __name__ == "__main__":
    sys.exit(main())
