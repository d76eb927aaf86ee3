"""Occupancy visualization (tools/analysis_tools/vis_occ.py equivalent): a
copy of ``dhd_tpu/cli/vis.py``.

Renders a BEV image of a (200, 200, 16) semantic occupancy grid — the same
max-height-wins projection as NuScenesDatasetOccpancy.vis_occ
(nuscenes_dataset_occ.py:147-167) — plus optional per-z-slice panels.

  python -m dhd_tpu_torch.cli.vis --occ pred.npy --out occ.png
"""
from __future__ import annotations

import argparse

import numpy as np

# Occ3D-ish palette (RGB 0-1), free class rendered white.
PALETTE = np.array([
    [0.6, 0.6, 0.6],     # others
    [1.0, 0.47, 0.3],    # barrier
    [1.0, 0.6, 0.1],     # bicycle
    [1.0, 0.81, 0.0],    # bus
    [0.0, 0.61, 1.0],    # car
    [0.4, 0.67, 0.1],    # construction_vehicle
    [1.0, 0.0, 0.3],     # motorcycle
    [0.0, 0.0, 0.9],     # pedestrian
    [1.0, 0.94, 0.0],    # traffic_cone
    [0.5, 0.35, 0.1],    # trailer
    [0.2, 0.2, 0.9],     # truck
    [0.0, 0.81, 0.75],   # driveable_surface
    [0.66, 0.44, 0.6],   # other_flat
    [0.45, 0.45, 0.9],   # sidewalk
    [0.47, 0.6, 0.33],   # terrain
    [0.75, 0.75, 0.75],  # manmade
    [0.0, 0.69, 0.0],    # vegetation
    [1.0, 1.0, 1.0],     # free
])


def occ_to_bev_rgb(occ: np.ndarray, free_id: int = 17) -> np.ndarray:
    """(Dx, Dy, Dz) class grid -> (Dy, Dx, 3) BEV image, highest occupied
    voxel wins (vis_occ semantics)."""
    occ = np.asarray(occ)
    dz = occ.shape[2]
    occupied = occ != free_id
    # index of highest occupied voxel, free -> -1
    top = np.where(occupied.any(-1),
                   (dz - 1) - np.argmax(occupied[..., ::-1], axis=-1), -1)
    cls = np.where(top >= 0,
                   np.take_along_axis(
                       occ, np.clip(top, 0, dz - 1)[..., None],
                       axis=-1)[..., 0],
                   free_id)
    rgb = PALETTE[cls]
    return np.transpose(rgb, (1, 0, 2))      # (Dy, Dx, 3)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--occ", required=True,
                   help=".npy (Dx, Dy, Dz) uint8 class grid, or labels.npz")
    p.add_argument("--out", default="occ_bev.png")
    p.add_argument("--slices", action="store_true",
                   help="also render 16 z-slice panels")
    args = p.parse_args()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if args.occ.endswith(".npz"):
        occ = np.load(args.occ)["semantics"]
    else:
        occ = np.load(args.occ)

    if args.slices:
        dz = occ.shape[2]
        fig, axes = plt.subplots(4, dz // 4 + (dz % 4 > 0),
                                 figsize=(16, 12))
        for z, ax in zip(range(dz), axes.ravel()):
            ax.imshow(np.transpose(PALETTE[occ[..., z]], (1, 0, 2)),
                      origin="lower")
            ax.set_title(f"z={z}")
            ax.axis("off")
    else:
        fig, ax = plt.subplots(figsize=(8, 8))
        ax.imshow(occ_to_bev_rgb(occ), origin="lower")
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_title("occupancy BEV (top voxel)")
    fig.savefig(args.out, dpi=120, bbox_inches="tight")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
