"""Ahead-of-time model export: counterpart of ``dhd_tpu/cli/export.py``
(the reference's tools/convert_bevdet_to_TRT.py).

The deployment artifact is a ``torch.export`` program (``.pt2``): the eval
forward over a batch of the model's inputs, ending in the voxel argmax as
uint8 (B, Dx, Dy, Dz), traced under ``torch.no_grad`` on the chosen device
(the GPU unless ``--device`` names another).  On the card the program
carries the hand-written kernels as the ``dhd_tpu_torch::`` custom ops
(B1 and its plan, and for DHD-M and DHD-L B3, B4, B5), which the loader
finds once ``dhd_tpu_torch.ops`` is imported (:func:`load_program`).
Temporal presets export the F-frame forward over the frames their batch
carries, as JAX's export does.

By default the artifact is JAX's split: a small program that takes the
``state_dict`` as an argument (the model is held outside the program's
module state, and the stored example inputs are dropped), plus
``<out>.weights.pt`` holding the ``state_dict``.  ``--bake-weights`` gives
one file with the weights inside.

``--int8`` calibrates per-tensor activation scales for the image
backbone's convs on ``--calib-batches`` batches (real ones through the
dataset and pipeline with ``--ann-file``, a short tail batch dropped;
synthetic otherwise) and exports with those convs int8
(:mod:`dhd_tpu_torch.nn.quant`).  Time an artifact with ``python -m
dhd_tpu_torch.cli.benchmark --what exported --artifact <file>``.

  python -m dhd_tpu_torch.cli.export --preset dhd_s --out dhd_s.pt2 --bf16
  python -m dhd_tpu_torch.cli.export --preset dhd_s --out dhd_s_int8.pt2 \\
      --bf16 --int8
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

META = "dhd_export.json"          # the program file's own description


class ArgmaxProgram(nn.Module):
    """What an artifact computes: ``model(batch)``'s voxel argmax as
    uint8.  ``forward(batch)`` with the model inside (baked weights), or
    ``forward(state, batch)`` with the model held outside the module
    state and its weights passed in (the split)."""

    def __init__(self, model: nn.Module, bake: bool):
        super().__init__()
        self.bake = bake
        if bake:
            self.model = model
        else:
            object.__setattr__(self, "held", model)

    def forward(self, *args):
        if self.bake:
            (batch,) = args
            out = self.model(batch)
        else:
            state, batch = args
            out = torch.func.functional_call(self.held, state, (batch,))
        return out["occ_logits"].argmax(-1).to(torch.uint8)


def batch_inputs(batch: Dict[str, Any], keys, device) -> Dict[str, Any]:
    """``batch``'s arrays named in ``keys`` as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(batch[k]) if not torch.is_tensor(
        batch[k]) else batch[k], device=device) for k in keys}


def export_program(model: nn.Module, batch: Dict[str, torch.Tensor],
                   bake: bool) -> Tuple[Any, torch.Tensor]:
    """Trace ``model``'s argmax program over ``batch`` (tensors on the
    model's device) with ``torch.export.export(strict=False)`` under
    ``torch.no_grad``.  The model runs once eagerly first: the device
    constants it keeps (frustums, Swin masks) are then real tensors,
    which the trace takes in as constants.  Returns the ExportedProgram
    and the eager argmax."""
    prog = ArgmaxProgram(model, bake)
    args = (batch,) if bake else (
        {k: v.detach() for k, v in model.state_dict().items()}, batch)
    with torch.no_grad():
        live = prog(*args)
        ep = torch.export.export(prog, args, strict=False)
    if not bake:
        ep.example_inputs = None     # they hold the weights
    return ep, live


def save_program(ep, path: str, meta: Dict[str, Any],
                 state: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Write the program (and the split's ``<path>.weights.pt``)."""
    torch.export.save(ep, path, extra_files={META: json.dumps(meta)})
    if state is not None:
        torch.save({k: v.detach() for k, v in state.items()},
                   path + ".weights.pt")


def load_program(path: str, device=None):
    """An artifact loaded fresh: (callable, meta).  The callable takes the
    batch dict (tensors on the program's device); a split artifact's
    weights come from ``<path>.weights.pt``, on ``device`` (default: the
    device the program was exported on)."""
    import dhd_tpu_torch.ops  # noqa: F401  (registers the custom ops)

    extra = {META: ""}
    ep = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META])
    device = torch.device(device if device is not None else meta["device"])
    fn = ep.module()
    wfile = path + ".weights.pt"
    if not os.path.exists(wfile):
        return fn, meta
    state = torch.load(wfile, map_location=device, weights_only=True)
    return (lambda batch: fn(state, batch)), meta


def calibration_batches(cfg, args, keys, device) -> Tuple[List, str]:
    """The int8 calibration batches and where they came from."""
    if args.ann_file:
        from dhd_tpu_torch.data.nuscenes import NuScenesOccDataset
        from dhd_tpu_torch.data.pipeline import SamplePipeline, collate
        ds = NuScenesOccDataset(args.ann_file, args.data_root,
                                num_adj_frames=cfg.num_adj_frames,
                                stereo=cfg.stereo)
        pipe = SamplePipeline(cfg, is_train=False, data_root=args.data_root)
        n = min(len(ds), args.calib_batches * args.batch_size)
        raw = [collate([pipe(ds.get_sample(j)) for j in
                        range(i, min(i + args.batch_size, n))])
               for i in range(0, n, args.batch_size)]
        # one program specialization: drop a short tail batch
        raw = [b for b in raw if b["imgs"].shape[0] == args.batch_size]
        return ([batch_inputs(b, keys, device) for b in raw],
                f"real ({args.ann_file})")
    from dhd_tpu_torch.data import synthetic_batch
    return ([batch_inputs(synthetic_batch(cfg, args.batch_size,
                                          with_gt=False, seed=100 + i),
                          keys, device)
             for i in range(args.calib_batches)], "synthetic")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Export DHD with the port")
    p.add_argument("--preset", default="dhd_s")
    p.add_argument("--out", required=True)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="reference .pth state_dict, or a port .pt")
    p.add_argument("--int8", action="store_true",
                   help="quantize the image backbone's convs to int8 "
                        "(per-tensor activation scales calibrated on "
                        "--calib-batches batches: real data when "
                        "--ann-file is given, synthetic otherwise)")
    p.add_argument("--calib-batches", type=int, default=2)
    p.add_argument("--bake-weights", action="store_true",
                   help="the weights inside the program (one file) instead "
                        "of the program + weights split")
    p.add_argument("--ann-file", default=None,
                   help="infos .pkl for real-data int8 calibration")
    p.add_argument("--data-root", default="")
    p.add_argument("--device", default=None,
                   help="default: the GPU (raises without one)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    from dhd_tpu_torch.config import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.device import resolve_device
    from dhd_tpu_torch.io import load_weights
    from dhd_tpu_torch.models import build_model

    dev = resolve_device(args.device)
    cfg = get_config(args.preset)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = build_model(cfg, dtype=dtype, device=dev)
    if args.checkpoint:
        load_weights(model, args.checkpoint)
    example = synthetic_batch(cfg, args.batch_size, with_gt=False)
    keys = sorted(example)
    batch = batch_inputs(example, keys, dev)

    if args.int8:
        from dhd_tpu_torch.nn.quant import (DEFAULT_PREFIXES, calibrate_int8,
                                            quantize_model)
        calib, src = calibration_batches(cfg, args, keys, dev)
        scales = calibrate_int8(model, calib, DEFAULT_PREFIXES)
        print(f"calibrated {len(scales)} conv activation scales "
              f"({len(calib)} {src} batches, prefixes={DEFAULT_PREFIXES})",
              flush=True)
        model = quantize_model(model, scales, DEFAULT_PREFIXES)

    t0 = time.perf_counter()
    ep, _ = export_program(model, batch, args.bake_weights)
    meta = {"preset": cfg.name, "batch_size": args.batch_size,
            "dtype": str(dtype).split(".")[-1], "int8": args.int8,
            "device": str(dev), "inputs": keys,
            "split": not args.bake_weights}
    save_program(ep, args.out, meta,
                 None if args.bake_weights else model.state_dict())
    if not args.bake_weights:
        wfile = args.out + ".weights.pt"
        print(f"weights -> {wfile} "
              f"({os.path.getsize(wfile) / 1e6:.1f} MB)")
    print(f"exported {args.preset}{' int8' if args.int8 else ''} -> "
          f"{args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB, "
          f"device={dev}, {time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
