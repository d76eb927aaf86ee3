#!/usr/bin/env python3
"""Run chip_smoke.py's DHD-M streaming phase (latency, device busy time,
host syncs and the cost-volume stage's trace reading) against the
``dhd_tpu_torch`` package of another checkout, to compare two trees on one
card.

    python3 chip_ab.py DIR

DIR is the root of a checkout (for example a ``git archive`` of the parent
commit unpacked under ``build/``).  Run it once per tree in one session, in
the order parent, change, change, parent.
"""
import importlib.util
import pathlib
import sys
import time


def main() -> int:
    tree = pathlib.Path(sys.argv[1]).resolve()
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
    cuda_build.build(cuda_build.SOURCES)
    print(f"package {pathlib.Path(dhd_tpu_torch.__file__).parent}; built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    kernels = {"mghs_pool_cuda": {}, "stereo_cost_volume_cuda": {}}
    smoke.phase_stream(torch.device("cuda"), kernels, smoke.smi_name_power())
    return 0


if __name__ == "__main__":
    sys.exit(main())
