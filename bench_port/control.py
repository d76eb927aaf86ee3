"""The readings that the check's limits are set from, on the card.

    python3 bench_port/control.py --workload <name> --seeds 1,2,3 \
        [--fault <name> --seconds <s>]

Without ``--fault`` it reads the control: the plain reference put in the
program's place and computed a precision lower than the configuration
states (bf16 there): for a serving cell every conv and dense layer's
operands rounded to fp8, at the frames a run would compare (its own
history for a stream); for a training cell the reference computing in
fp8 wherever the program holds bf16 (``compute_in_fp8``), through the same
first steps.  It is compared with the fp32 reference by the numbers a run
compares.  With ``--fault`` it runs the cell with that fault planted in
the timed path (:data:`bench_port.loops.FAULTS`) for ``--seconds``.  One
JSON line per seed, with ``correct`` as the cell's limits judge the
numbers.  The benchmark's own runs never run either.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(loop) -> dict:
    from bench_port.loops import TrainLoop, _free
    if isinstance(loop, TrainLoop):
        ref = loop.follow(fp8=False)
        loop.ref_model = None
        _free()
        low = loop.follow(fp8=True)
        loop.losses, loop.grad_norms = low["losses"], low["grads"]
        loop.gnorms = low["gnorms"]
        loop.change_norms = low["change"]
        loop.logits = low["logits"]
        return loop.compare(ref, count_flops=False)
    # as many frames as a run serves, the compared ones drawn as it draws
    loop.frame_no = loop.traffic["warm_frames"] + loop.traffic[
        "control_frames"]
    return loop.check_frames(loop.sample(), fp8=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port import harness
    from bench_port.loops import loop_for

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.fault:
            r = harness.run_cell(cell, seed, args.seconds, False, dev,
                                 fault=args.fault)
            numbers = {k: v["value"] for k, v in r["checks"].items()}
        else:
            numbers = control_numbers(
                loop_for(cell.config, cell.traffic, seed, dev))
        _, correct = harness.judge(numbers, cell.limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault or "control_fp8",
                          "correct": correct, "numbers": numbers}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
