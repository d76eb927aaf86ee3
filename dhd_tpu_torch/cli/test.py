"""Evaluation CLI of the port: counterpart of ``dhd_tpu/cli/test.py`` (the
reference's tools/test.py), with its flags and printed lines.

  python -m dhd_tpu_torch.cli.test --preset dhd_s --ann-file infos_val.pkl \\
      --checkpoint work_dirs/dhd_s/epoch_24.pt --use-ema --eval miou
  python -m dhd_tpu_torch.cli.test --preset dhd_tiny --synthetic \\
      --device cpu                                          # smoke

A process evaluates on one device: the GPU unless ``--device`` names
another (it raises when there is no GPU and no ``--device``).  Under
``torchrun --nproc_per_node=N`` the processes evaluate disjoint shares of
the batches (batch j on rank j mod N); the confusion matrices are summed
over them and RayIoU's per-sample grids gathered to rank 0, which prints
the metrics of the whole set (the JAX CLI shards each batch over its
devices instead: the metrics are the same).  The
forward runs under ``torch.inference_mode`` (kernels B1, B3, B4 and B5 on
the GPU), the argmax and the confusion matrix stay on the device, and
``--eval ray-iou`` marches the lidar fan on it.  Temporal presets align
the history grids after the view transformation, as the reference's
evaluation does, unless ``--no-aavt``.  ``--checkpoint`` reads a reference
``.pth`` state_dict (strict) or a port ``.pt`` from ``cli/train``
(``--use-ema``: its EMA weights).  The JAX package's orbax directories
are not read here: they exit 1.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate DHD with the port")
    p.add_argument("--preset", default="dhd_s")
    p.add_argument("--ann-file", default=None)
    p.add_argument("--data-root", default="")
    p.add_argument("--checkpoint", default=None,
                   help="reference .pth state_dict, or a port .pt")
    p.add_argument("--eval", default="miou", choices=["miou", "ray-iou"])
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--use-ema", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--no-aavt", action="store_true",
                   help="do NOT align after view transformation for "
                        "temporal models (tools/test.py:235-237 forces "
                        "alignment at eval by default)")
    p.add_argument("--device", default=None,
                   help="default: the GPU (raises without one)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    from dhd_tpu_torch import parallel
    from dhd_tpu_torch.device import resolve_device

    with parallel.process_group(resolve_device(args.device)) as dev:
        return _evaluate(args, dev)


def _evaluate(args: argparse.Namespace, dev: torch.device) -> int:
    import dataclasses

    from dhd_tpu_torch import parallel
    from dhd_tpu_torch.config import get_config
    from dhd_tpu_torch.eval import MIoUMetric
    from dhd_tpu_torch.io import load_weights
    from dhd_tpu_torch.models import build_model

    world, rank = parallel.world_size(), parallel.rank()
    cfg = get_config(args.preset)
    if cfg.temporal and not args.no_aavt:
        cfg = dataclasses.replace(cfg, align_after_view_transformation=True)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = build_model(cfg, dtype=dtype, device=dev)
    if args.checkpoint:
        load_weights(model, args.checkpoint, args.use_ema)

    # every batch comes as (sample_indices, batch), so the ray-iou origins
    # follow the samples evaluated
    if args.synthetic or args.ann_file is None:
        from dhd_tpu_torch.data import synthetic_batch
        bs = args.batch_size
        batches = ((list(range(i * bs, (i + 1) * bs)),
                    synthetic_batch(cfg, batch_size=bs, seed=i))
                   for i in range(2))
        infos = None
    else:
        from dhd_tpu_torch.data.nuscenes import NuScenesOccDataset
        from dhd_tpu_torch.data.pipeline import SamplePipeline, collate
        ds = NuScenesOccDataset(args.ann_file, args.data_root,
                                num_adj_frames=cfg.num_adj_frames,
                                stereo=cfg.stereo)
        pipe = SamplePipeline(cfg, is_train=False, data_root=args.data_root)
        n = min(len(ds), args.limit or len(ds))

        def gen():
            # every sample once: the tail batch is smaller, not dropped
            # (the reference evaluates all of val, tools/test.py:286)
            for i in range(0, n, args.batch_size):
                idxs = list(range(i, min(i + args.batch_size, n)))
                yield idxs, collate([pipe(ds.get_sample(j)) for j in idxs])
        batches = gen()
        infos = ds.data_infos

    metric = MIoUMetric()
    preds_list, gts_list, token_idx = [], [], []
    n_eval = 0
    with torch.inference_mode():
        for j, (idxs, batch) in enumerate(batches):
            if j % world != rank:
                continue
            n_eval += len(idxs)
            occ = model(batch)["occ_logits"].argmax(-1).to(torch.uint8)
            metric.add_batch(occ, batch["voxel_semantics"],
                             batch["mask_camera"])
            if args.eval == "ray-iou":
                preds_list.extend(list(occ.cpu().numpy()))
                gts_list.extend(list(batch["voxel_semantics"]))
                token_idx.extend(idxs)

    if world > 1:
        cm = torch.from_numpy(np.append(metric.cm.reshape(-1), n_eval))
        cm = parallel.sum_over_processes(cm.to(dev)).cpu().numpy()
        metric.cm, n_eval = cm[:-1].reshape(metric.cm.shape), int(cm[-1])
        metric.count = n_eval
        shares = parallel.gather_objects((token_idx, preds_list, gts_list))
        order = sorted(((i, p, g) for t, ps, gs in shares
                        for i, p, g in zip(t, ps, gs)), key=lambda e: e[0])
        token_idx = [i for i, _, _ in order]
        preds_list = [p for _, p, _ in order]
        gts_list = [g for _, _, g in order]
        if rank:
            return 0

    if args.eval == "ray-iou" and infos is not None:
        from dhd_tpu_torch.eval import rayiou_from_outputs, scene_origins
        print("rayiou-samples: "
              + " ".join(infos[i]["token"] for i in token_idx))
        origins = [scene_origins(infos, i) for i in token_idx]
        vt = cfg.vt
        pc_range = (vt.x.lower, vt.y.lower, vt.z_fine.lower,
                    vt.x.upper, vt.y.upper, vt.z_fine.upper)
        res = rayiou_from_outputs(preds_list, gts_list, origins, pc_range,
                                  vt.x.interval, device=dev)
        for k in ("RayIoU", "RayIoU@1", "RayIoU@2", "RayIoU@4"):
            print(f"{k}: {res[k]:.4f}")
    print(f"evaluated {n_eval} samples")
    print(metric.summary(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
