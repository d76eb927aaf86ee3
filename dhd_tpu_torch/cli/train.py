"""Training CLI of the port: counterpart of ``dhd_tpu/cli/train.py`` (the
reference's tools/train.py).

  python -m dhd_tpu_torch.cli.train --preset dhd_s --synthetic --steps 10
  python -m dhd_tpu_torch.cli.train --preset dhd_l --synthetic --steps 2 \
      --bf16
  python -m dhd_tpu_torch.cli.train --preset dhd_tiny --synthetic --steps 2 \\
      --device cpu --work-dir work_dirs/tiny

One process trains on one device: the GPU unless ``--device`` names
another (it raises when there is no GPU and no ``--device``).  Synthetic
epochs are four batches of ``synthetic_batch`` (seeds ``--seed + i``), as
in the JAX CLI.  With ``--work-dir`` each logged step appends a line to
``metrics.jsonl`` and every ``--ckpt-interval`` epochs ``epoch_N.pt``
holds the model, optimiser, EMA, step and dropout generator
(``dhd_tpu_torch.io.save_checkpoint``); ``--resume-from`` and
``--auto-resume`` continue from one, ``--load-from`` warm-starts the
model from a reference-keyed ``.pth`` state_dict.  ``--bf16`` is mixed
precision as in the JAX CLI: the forward in bf16 over fp32 master weights,
the losses, gradients, AdamW moments and EMA in fp32 (checkpoints are
fp32 either way).  The nuScenes loader (``--ann-file``) and multi-device
runs are not ported yet: they exit 1 naming ROADMAP.md.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Tuple

import torch

# the reference's per-GPU batch (dhd_tpu/cli/train.py:73)
PER_GPU_BATCH = {"dhd_s": 4, "dhd_m": 3, "dhd_l": 2}
N_SYNTHETIC_BATCHES = 4
NOT_PORTED = {
    "ann_file": "--ann-file (the nuScenes loader, ROADMAP.md §A.6)",
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train DHD with the port")
    p.add_argument("--preset", default="dhd_s")
    p.add_argument("--ann-file", default=None,
                   help="bevdetv2 infos pkl (not ported yet)")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: the reference per-GPU batch")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="cap total steps (debug)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic data")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision: bf16 forward, fp32 weights")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--ckpt-interval", type=int, default=1,
                   help="epochs between checkpoints")
    p.add_argument("--resume-from", default=None)
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from the newest epoch_N.pt in --work-dir")
    p.add_argument("--temporal-start-epoch", type=int, default=None,
                   help="train without history frames until this epoch "
                        "(SequentialControlHook); default: always use them")
    p.add_argument("--load-from", default=None,
                   help="warm-start .pth state_dict in the reference key "
                        "space")
    p.add_argument("--device", default=None,
                   help="default: the GPU (raises without one)")
    return p.parse_args(argv)


def _newest_checkpoint(work_dir: Optional[str]) -> Tuple[Optional[str], int]:
    """The newest ``epoch_N.pt`` in ``work_dir`` and N, or (None, 0)."""
    if not work_dir or not os.path.isdir(work_dir):
        return None, 0
    epochs = [int(f[6:-3]) for f in os.listdir(work_dir)
              if f.startswith("epoch_") and f.endswith(".pt")
              and f[6:-3].isdigit()]
    if not epochs:
        return None, 0
    return os.path.join(work_dir, f"epoch_{max(epochs)}.pt"), max(epochs)


def _reference_state_dict(path: str):
    """A reference ``.pth``: the state_dict itself, or mmcv's checkpoint
    dict holding it under ``state_dict``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt.get("state_dict", ckpt)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    for flag, msg in NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"{msg} is not ported yet")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise SystemExit("multi-device training (ROADMAP.md §A.9) is not "
                         "ported yet")

    from dhd_tpu_torch.config import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.device import resolve_device
    from dhd_tpu_torch.io import load_checkpoint, save_checkpoint
    from dhd_tpu_torch.models import build_model
    from dhd_tpu_torch.profiling import kernel_launches
    from dhd_tpu_torch.train import AdamWSchedule, ModelEMA, train_step

    dev = resolve_device(args.device)
    cfg = get_config(args.preset)
    batch_size = args.batch_size or PER_GPU_BATCH.get(cfg.name, 1)
    epochs = args.epochs or cfg.optim.max_epochs
    steps_per_epoch = N_SYNTHETIC_BATCHES

    def epoch_batches():
        for i in range(0, N_SYNTHETIC_BATCHES * batch_size, batch_size):
            yield synthetic_batch(cfg, batch_size=batch_size,
                                  seed=args.seed + i)

    compute_dtype = torch.bfloat16 if args.bf16 else None
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(args.seed))
    if args.load_from:
        model.load_state_dict(_reference_state_dict(args.load_from),
                              strict=True)
    optimizer = AdamWSchedule(model.parameters(), cfg.optim,
                              steps_per_epoch)
    ema = ModelEMA(model, cfg.optim.ema_init_updates, cfg.optim.ema_decay)
    generator = torch.Generator(device=dev).manual_seed(args.seed + 1)
    step = start_epoch = 0
    resume = args.resume_from
    if args.auto_resume and not resume:
        resume, start_epoch = _newest_checkpoint(args.work_dir)
        if resume:
            print(f"auto-resuming from {resume}", flush=True)
    if resume:
        step = load_checkpoint(resume, model, optimizer, ema, generator)

    print(f"{cfg.name}: B={batch_size} on {dev}, "
          f"{'bf16 mixed precision' if args.bf16 else 'fp32'}", flush=True)
    log_file = None
    if args.work_dir:
        os.makedirs(args.work_dir, exist_ok=True)
        log_file = open(os.path.join(args.work_dir, "metrics.jsonl"), "a")
    try:
        t0 = time.perf_counter()
        first = step
        for epoch in range(start_epoch, epochs):
            with_prev = (args.temporal_start_epoch is None
                         or epoch > args.temporal_start_epoch)
            for batch in epoch_batches():
                metrics = train_step(model, optimizer, ema, batch, generator,
                                     with_prev=with_prev,
                                     compute_dtype=compute_dtype)
                step += 1
                last = bool(args.steps) and step >= args.steps
                if step % args.log_interval == 0 or last:
                    m = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                    print(f"epoch {epoch} step {step} "
                          f"({dt / max(step - first, 1):.2f}s/it) "
                          + " ".join(f"{k}={v:.4f}"
                                     for k, v in sorted(m.items())),
                          flush=True)
                    if log_file is not None:
                        log_file.write(json.dumps(
                            {"epoch": epoch, "step": step, **m}) + "\n")
                        log_file.flush()
                if last:
                    break
            if args.work_dir and (epoch + 1) % args.ckpt_interval == 0:
                path = os.path.join(args.work_dir, f"epoch_{epoch + 1}.pt")
                save_checkpoint(path, model, optimizer, ema, step, generator)
                print(f"saved checkpoint {path}", flush=True)
            if args.steps and step >= args.steps:
                break
    finally:
        if log_file is not None:
            log_file.close()
    if dev.type == "cuda":
        print("kernel launches: " + ", ".join(
            f"{k} {v}" for k, v in kernel_launches().items() if v),
            flush=True)
    print("training done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
