"""Shared pieces of the benchmark's CPU tests: small configurations and a
cell of ``BENCHMARK.json`` run at one of them."""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402
from bench_port.reference.config import config_from_dict  # noqa: E402

CPU = torch.device("cpu")


def get_config(preset: str):
    """The port's preset ``preset`` as the reference reads it: through
    the same dictionary a configuration file holds."""
    from dhd_tpu_torch import get_config as port_preset
    return config_from_dict(json.loads(json.dumps(
        dataclasses.asdict(port_preset(preset)))))


def tiny_dhd_l():
    """dhd_tiny_stereo at 64x192 with a Swin-B-shaped backbone (embed 16,
    depths (1, 1, 2, 1), heads (1, 2, 4, 8), window 4) and the FPN_LSS
    neck: the port's tests' tiny DHD-L-shaped configuration."""
    base = get_config("dhd_tiny_stereo")
    return dataclasses.replace(
        base, name="tiny_dhd_l",
        vt=dataclasses.replace(base.vt, input_size=(64, 192)),
        backbone="swin_base", swin_embed_dims=16, swin_depths=(1, 1, 2, 1),
        swin_num_heads=(1, 2, 4, 8), swin_window=4, img_neck="fpn_lss",
        img_neck_in_channels=(64, 128),
        img_neck_out_channels=base.vt.in_channels, sfa_in_channels=128)


SMALL = {"dhd_l": (tiny_dhd_l, "dhd_tiny_stereo"),
         "dhd_s": (lambda: get_config("dhd_tiny"), "dhd_tiny")}


def config_file(cfg, preset: str, precision: str = "float32",
                train_batch: int = 2) -> dict:
    """A configuration file's contents for ``cfg``."""
    return {"name": cfg.name, "preset": preset, "precision": precision,
            "train_batch": train_batch, "reduced": [],
            "model": json.loads(json.dumps(dataclasses.asdict(cfg)))}


def _layer(name, unit, better, layer):
    return {"name": name, "unit": unit, "better": better,
            "source": "device_trace", "layer": layer, "moves": "step_ms",
            "workloads": ["dhd_l.train"]}


# the training cell, which BENCHMARK.json leaves out until a compared
# number separates its control from sound runs: its loop, readers and
# limits stay under test
TRAIN = {
    "workload": {"name": "dhd_l.train", "config": "dhd_l",
                 "traffic": "train", "chips": 1, "why": "training"},
    "end_to_end": {"name": "step_ms", "unit": "ms", "better": "lower",
                   "bound": 0.1, "source": "host_clock",
                   "workloads": ["dhd_l.train"]},
    "per_layer": [
        _layer("idle_share.train", "%", "lower", "device"),
        _layer("launches_per_step", "launches/step", "lower",
               "host, eager dispatch"),
        _layer("mfu.train", "%", "higher", "train step (train/step.py)"),
        _layer("elementwise_share.train", "%", "lower",
               "train step (train/step.py)")]}


def small_cell(workload: str, precision: str = "float32",
               traced_items: int = 2) -> harness.Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its traffic mix and
    limits, at the small configuration standing in for its own."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    if workload == TRAIN["workload"]["name"]:
        spec["workloads"].append(TRAIN["workload"])
        spec["end_to_end"].append(TRAIN["end_to_end"])
        spec["per_layer"] += TRAIN["per_layer"]
    cell = harness.Cell(spec, workload)
    make, preset = SMALL[cell.spec["config"]]
    cell.config = config_file(make(), preset, precision,
                              min(cell.config.get("train_batch", 2), 2))
    cell.traffic = dict(cell.traffic, traced_items=traced_items,
                        detail_items=1, image_pool=4, control_frames=12)
    if "weight_gain" in cell.traffic:
        # at these widths the served argmax is blind to the stream's
        # history below He's scale (a frozen cache moves no voxel at 1.4,
        # 11% of them at 2); the cells' own sizes see it at 1.4
        cell.traffic["weight_gain"] = 2.0
    return cell


def quiet(_line: str) -> None:
    pass
