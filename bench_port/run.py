"""Run one cell of the port's benchmark on this machine's cards.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench_port/``
and the port (``dhd_tpu_torch/``).  It prints the result as one JSON
object on the last line of standard output, and each number the check
compares beside its limit as the last lines of standard error.  Without
as many CUDA cards as the cell asks for it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run at a fixed place inside the checkout
    out = ROOT / "bench_port" / "out"
    os.environ.setdefault("TRITON_CACHE_DIR", str(out / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(out / "extensions"))
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port import harness

    cell = harness.load_cell(args.workload, ROOT)
    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port "
              f"alone", file=sys.stderr)
        return 3
    checks = result["checks"]
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
