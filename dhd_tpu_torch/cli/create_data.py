"""Dataset preparation CLI (tools/create_data_bevdet.py equivalent): a copy
of ``dhd_tpu/cli/create_data.py``.

Builds ``bevdetv2-nuscenes_infos_{train,val}.pkl`` directly from a raw
nuScenes tree — no mmdet3d/nuscenes-devkit dependency, just the JSON tables.
Per sample we record exactly the fields the reference pipeline consumes
(datasets/pipelines/loading.py + nuscenes_dataset_bevdet.py:196-278):
token, timestamp, scene_token, lidar_path, lidar2ego_*, ego2global_* (lidar
timestamp), per-camera data_path / cam_intrinsic / sensor2ego_* /
ego2global_* (camera timestamp), and occ_path -> Occ3D gts
(tools/create_data_bevdet.py:100-134).

  python -m dhd_tpu_torch.cli.create_data --data-root data/nuscenes \
      --version v1.0-trainval --out-dir data/nuscenes
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import zlib
from typing import Dict, List

CAM_NAMES = (
    "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
    "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT",
)

# official nuScenes trainval scene split sizes are resolved from the
# devkit's split lists when present; otherwise we split by scene name.
try:
    from nuscenes.utils.splits import train as TRAIN_SCENES  # type: ignore
    from nuscenes.utils.splits import val as VAL_SCENES  # type: ignore
except Exception:                                    # pragma: no cover
    TRAIN_SCENES = VAL_SCENES = None


def fallback_is_val(scene_token: str) -> bool:
    """Deterministic 85/15 split by scene digest when the devkit split
    lists are unavailable.  crc32 is stable across processes and
    platforms; Python's ``hash()`` is salted per process (PYTHONHASHSEED)
    and would give a different split each run."""
    return (zlib.crc32(scene_token.encode()) % 100) < 15


def load_table(root: str, version: str, name: str) -> List[dict]:
    with open(os.path.join(root, version, f"{name}.json")) as f:
        return json.load(f)


def build_infos(data_root: str, version: str) -> Dict[str, List[dict]]:
    tables = {n: load_table(data_root, version, n) for n in
              ("sample", "sample_data", "ego_pose", "calibrated_sensor",
               "sensor", "scene")}
    by_token = {n: {r["token"]: r for r in t}
                for n, t in tables.items()}
    scene_name = {r["token"]: r["name"] for r in tables["scene"]}

    # index sample_data by (sample, channel), keyframes only
    sd_index: Dict[tuple, dict] = {}
    for sd in tables["sample_data"]:
        if not sd["is_key_frame"]:
            continue
        cs = by_token["calibrated_sensor"][sd["calibrated_sensor_token"]]
        channel = by_token["sensor"][cs["sensor_token"]]["channel"]
        sd_index[(sd["sample_token"], channel)] = sd

    infos = []
    for sample in tables["sample"]:
        lidar_sd = sd_index.get((sample["token"], "LIDAR_TOP"))
        if lidar_sd is None:
            continue
        lidar_cs = by_token["calibrated_sensor"][
            lidar_sd["calibrated_sensor_token"]]
        lidar_pose = by_token["ego_pose"][lidar_sd["ego_pose_token"]]
        cams = {}
        ok = True
        for cam in CAM_NAMES:
            sd = sd_index.get((sample["token"], cam))
            if sd is None:
                ok = False
                break
            cs = by_token["calibrated_sensor"][sd["calibrated_sensor_token"]]
            pose = by_token["ego_pose"][sd["ego_pose_token"]]
            cams[cam] = {
                "data_path": os.path.join(data_root, sd["filename"]),
                "cam_intrinsic": cs["camera_intrinsic"],
                "sensor2ego_rotation": cs["rotation"],
                "sensor2ego_translation": cs["translation"],
                "ego2global_rotation": pose["rotation"],
                "ego2global_translation": pose["translation"],
            }
        if not ok:
            continue
        sname = scene_name[sample["scene_token"]]
        infos.append({
            "token": sample["token"],
            "timestamp": sample["timestamp"],
            "scene_token": sample["scene_token"],
            "scene_name": sname,
            "lidar_path": os.path.join(data_root, lidar_sd["filename"]),
            "lidar2ego_rotation": lidar_cs["rotation"],
            "lidar2ego_translation": lidar_cs["translation"],
            "ego2global_rotation": lidar_pose["rotation"],
            "ego2global_translation": lidar_pose["translation"],
            "sweeps": [],
            "cams": cams,
            # Occ3D gt layout (create_data_bevdet.py:131-133)
            "occ_path": os.path.join(data_root, "gts", sname,
                                     sample["token"]),
        })

    if TRAIN_SCENES is not None:
        train = [i for i in infos if i["scene_name"] in set(TRAIN_SCENES)]
        val = [i for i in infos if i["scene_name"] in set(VAL_SCENES)]
    else:
        train = [i for i in infos if not fallback_is_val(i["scene_token"])]
        val = [i for i in infos if fallback_is_val(i["scene_token"])]
    return {"train": train, "val": val}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--out-dir", default=None)
    args = p.parse_args()
    out_dir = args.out_dir or args.data_root
    splits = build_infos(args.data_root, args.version)
    for split, infos in splits.items():
        path = os.path.join(out_dir,
                            f"bevdetv2-nuscenes_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"infos": infos,
                         "metadata": {"version": args.version}}, f)
        print(f"wrote {len(infos)} infos -> {path}")


if __name__ == "__main__":
    main()
