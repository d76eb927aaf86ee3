"""Training-log analysis (tools/analysis_tools/analyze_logs.py equivalent):
a copy of ``dhd_tpu/cli/analyze_logs.py``.

Consumes the metrics.jsonl our train CLI writes (one json object per logged
step: {"epoch", "step", "loss_total", "loss_occ", ..., "lr",
"samples_per_sec"}) instead of the mmcv json log.

  python -m dhd_tpu_torch.cli.analyze_logs plot work_dirs/dhd_s/metrics.jsonl \
      --keys loss_total loss_occ --out curves.png
  python -m dhd_tpu_torch.cli.analyze_logs time work_dirs/dhd_s/metrics.jsonl
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict


def load_metrics(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def cmd_plot(args):
    rows = load_metrics(args.jsonl)
    if not rows:
        print("no metrics found")
        return
    keys = args.keys or [k for k in rows[0] if k.startswith("loss")]
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 5))
    xs = list(range(len(rows)))
    for k in keys:
        ys = [r.get(k) for r in rows]
        if all(v is None for v in ys):
            print(f"key {k!r} not in log; available: {sorted(rows[0])}")
            continue
        ax.plot(xs, [v if v is not None else float("nan") for v in ys],
                label=k)
    ax.set_xlabel("logged step")
    ax.set_yscale("log" if args.log_scale else "linear")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out} ({len(rows)} points, keys={keys})")


def cmd_time(args):
    """Per-epoch throughput / loss summary (the cal_train_time analogue)."""
    rows = load_metrics(args.jsonl)
    by_epoch = defaultdict(list)
    for r in rows:
        by_epoch[r.get("epoch", 0)].append(r)
    print(f"{'epoch':>6} {'steps':>6} {'samples/s':>10} "
          f"{'loss_total':>11} {'lr':>10}")
    for ep in sorted(by_epoch):
        rs = by_epoch[ep]
        sps = [r["samples_per_sec"] for r in rs if "samples_per_sec" in r]
        lt = [r["loss_total"] for r in rs if "loss_total" in r]
        lr = [r["lr"] for r in rs if "lr" in r]
        print(f"{ep:>6} {len(rs):>6} "
              f"{(sum(sps) / len(sps)) if sps else float('nan'):>10.2f} "
              f"{(sum(lt) / len(lt)) if lt else float('nan'):>11.4f} "
              f"{(lr[-1] if lr else float('nan')):>10.2e}")


def main():
    p = argparse.ArgumentParser(description="Analyze DHD training logs")
    sub = p.add_subparsers(dest="cmd", required=True)
    pp = sub.add_parser("plot", help="plot loss/lr curves to a png")
    pp.add_argument("jsonl")
    pp.add_argument("--keys", nargs="*", default=None)
    pp.add_argument("--out", default="curves.png")
    pp.add_argument("--log-scale", action="store_true")
    pp.set_defaults(fn=cmd_plot)
    pt = sub.add_parser("time", help="per-epoch throughput/loss table")
    pt.add_argument("jsonl")
    pt.set_defaults(fn=cmd_time)
    args = p.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
