"""The port's evaluation CLI (dhd_tpu_torch.cli.test) in-process on the CPU,
on the on-disk fixture of tests/test_data_pipeline.py: dhd_tiny with JAX's
weights (converted by ``load_jax_variables``, saved as a ``.pth``) predicts
what JAX's eval forward predicts, and its mIoU and RayIoU lines are JAX's
metrics of the grids it predicted; ``--synthetic``, ``--bf16``, a
temporal preset, ``--use-ema`` from a ``cli/train`` checkpoint,
``cli/train --ann-file``, and the host-only CLIs (``create_data``,
``vis``, ``analyze_logs``) against JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu.config import get_config as j_config
from dhd_tpu.data.nuscenes import NuScenesOccDataset as JDataset
from dhd_tpu.data.pipeline import SamplePipeline as JPipeline
from dhd_tpu.data.pipeline import collate as j_collate
from dhd_tpu.eval import MIoUMetric as JMIoU
from dhd_tpu.eval import rayiou_from_outputs as j_rayiou
from dhd_tpu.eval import scene_origins as j_origins
from dhd_tpu.models import build_model as j_build_model
from dhd_tpu_torch.cli import test as cli
from dhd_tpu_torch.cli.train import main as train_main
from dhd_tpu_torch.config import get_config
from dhd_tpu_torch.eval import MIoUMetric
from dhd_tpu_torch.io import load_jax_variables, load_weights
from dhd_tpu_torch.models import build_model
from tests.test_data_pipeline import _write_fixture

ARGMAX_MIN = 0.999          # voxels with JAX's predicted class


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: under the test lane's parallel
    workers, thousands of small ops (the DDA loops) otherwise stall on the
    other workers' OpenMP threads (~40x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The fixture, JAX's dhd_tiny (one jitted init and eval forward at
    B=1) and its predictions for samples 0-2, and its weights as a .pth."""
    root = tmp_path_factory.mktemp("nus")
    pkl = _write_fixture(str(root))
    cfg = j_config("dhd_tiny")
    ds = JDataset(pkl)
    pipe = JPipeline(cfg, is_train=False)
    batches = [j_collate([pipe(ds.get_sample(i))]) for i in range(3)]
    jmodel = j_build_model(cfg)
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v)
                                for k, v in batches[0].items()})
    fwd = jax.jit(lambda v, b: jnp.argmax(
        jmodel.apply(v, b, train=False)["occ_logits"], -1).astype(jnp.uint8))
    preds = [np.asarray(fwd(variables, {k: jnp.asarray(v)
                                        for k, v in b.items()}))[0]
             for b in batches]
    model = build_model(get_config("dhd_tiny"), device="cpu")
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables),
                       get_config("dhd_tiny"))
    pth = root / "dhd_tiny.pth"
    torch.save(model.state_dict(), pth)
    gts = [b["voxel_semantics"][0] for b in batches]
    masks = [b["mask_camera"][0] for b in batches]
    return pkl, str(pth), ds.data_infos, preds, gts, masks


@pytest.fixture
def recorded(monkeypatch):
    """The prediction grids the CLI scores, as it passes them to
    ``MIoUMetric.add_batch``."""
    grids = []
    add = MIoUMetric.add_batch

    def record(self, pred, gt, mask):
        assert pred.dtype == torch.uint8
        grids.extend(pred.cpu().numpy())
        return add(self, pred, gt, mask)

    monkeypatch.setattr(MIoUMetric, "add_batch", record)
    return grids


def _lines(out):
    return [ln for ln in out.splitlines() if ln]


@pytest.mark.parametrize("evaluate", ["miou", "ray-iou"])
def test_cli_on_the_fixture_predicts_and_scores_as_jax(
        tiny, recorded, capsys, evaluate):
    """Three samples at batch 2 (a tail batch of one): every sample once,
    in order; at least 99.9% of voxels with JAX's class; the printed mIoU
    table (and RayIoU lines) equal to JAX's metrics of the same grids."""
    pkl, pth, infos, jpreds, gts, masks = tiny
    assert cli.main(["--preset", "dhd_tiny", "--ann-file", pkl,
                     "--checkpoint", pth, "--limit", "3", "--batch-size",
                     "2", "--eval", evaluate, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert len(recorded) == 3
    agree = np.mean([(p == j).mean() for p, j in zip(recorded, jpreds)])
    assert agree >= ARGMAX_MIN, agree
    assert "evaluated 3 samples" in out
    jm = JMIoU()
    for p, g, m in zip(recorded, gts, masks):
        jm.add_batch(p[None], g[None], m[None])
    assert _lines(jm.summary()) == _lines(out)[-len(_lines(jm.summary())):]
    assert ("rayiou-samples: tok0 tok1 tok2" in out) == (evaluate ==
                                                         "ray-iou")
    if evaluate == "ray-iou":
        vt = j_config("dhd_tiny").vt
        res = j_rayiou(recorded, gts, [j_origins(infos, i) for i in range(3)],
                       (vt.x.lower, vt.y.lower, vt.z_fine.lower,
                        vt.x.upper, vt.y.upper, vt.z_fine.upper),
                       vt.x.interval)
        for k in ("RayIoU", "RayIoU@1", "RayIoU@2", "RayIoU@4"):
            assert f"{k}: {res[k]:.4f}" in _lines(out)


def test_cli_synthetic_bf16_and_a_temporal_preset(tiny, recorded, capsys):
    assert cli.main(["--preset", "dhd_tiny", "--synthetic", "--batch-size",
                     "2", "--bf16", "--device", "cpu"]) == 0
    assert "evaluated 4 samples" in capsys.readouterr().out
    assert len(recorded) == 4
    pkl = tiny[0]
    assert cli.main(["--preset", "dhd_tiny_stereo", "--ann-file", pkl,
                     "--limit", "2", "--eval", "ray-iou",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "rayiou-samples: tok0 tok1" in out and "RayIoU@4" in out


def test_cli_use_ema_from_a_train_checkpoint(tmp_path, capsys):
    """``--use-ema`` evaluates the EMA weights ``cli/train`` stored, not the
    live ones."""
    wd = tmp_path / "wd"
    assert train_main(["--preset", "dhd_tiny", "--synthetic", "--steps",
                       "1", "--device", "cpu", "--work-dir", str(wd)]) == 0
    ckpt = wd / "epoch_1.pt"
    state = torch.load(ckpt, weights_only=True)
    cfg = get_config("dhd_tiny")
    for use_ema in (False, True):
        model = build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(5))
        load_weights(model, ckpt, use_ema)
        src = state["ema"]["shadow"] if use_ema else state["model"]
        w = "occ_head.final_conv.conv.weight"
        assert torch.equal(model.state_dict()[w], src[w])
    assert not torch.equal(state["ema"]["shadow"][w], state["model"][w])
    assert cli.main(["--preset", "dhd_tiny", "--synthetic", "--checkpoint",
                     str(ckpt), "--use-ema", "--device", "cpu"]) == 0
    assert "evaluated 2 samples" in capsys.readouterr().out


def test_train_cli_on_the_fixture(tiny, tmp_path, capsys):
    """``cli/train --ann-file``: two steps through the dataset, the
    augmenting pipeline (the native lidar projection) and the loader."""
    assert train_main(["--preset", "dhd_tiny", "--ann-file", tiny[0],
                       "--steps", "2", "--batch-size", "2", "--log-interval",
                       "1", "--device", "cpu", "--work-dir",
                       str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("loss_total=") == 2 and "training done" in out
    assert (tmp_path / "metrics.jsonl").exists()


def test_cli_refusals(tmp_path, monkeypatch):
    """No GPU and no ``--device`` raises; an orbax directory exits 1; a
    multi-device run without torchrun's rendezvous (``MASTER_ADDR``)
    raises."""
    (tmp_path / "orbax").mkdir()
    with pytest.raises(SystemExit, match="orbax"):
        cli.main(["--preset", "dhd_tiny", "--synthetic", "--device", "cpu",
                  "--checkpoint", str(tmp_path / "orbax")])
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        cli.main(["--preset", "dhd_tiny", "--synthetic", "--device", "cpu"])
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--preset", "dhd_tiny", "--synthetic"])


def _nuscenes_tables(root, version="v1.0-mini"):
    """The six JSON tables ``create_data`` reads: two scenes of two
    samples, each with a lidar sweep and six cameras."""
    import json
    import os
    from dhd_tpu_torch.data.nuscenes import CAM_NAMES
    rows = {n: [] for n in ("sample", "sample_data", "ego_pose",
                            "calibrated_sensor", "sensor", "scene")}
    for c, ch in enumerate(("LIDAR_TOP",) + CAM_NAMES):
        rows["sensor"].append({"token": f"sen{c}", "channel": ch})
        rows["calibrated_sensor"].append({
            "token": f"cs{c}", "sensor_token": f"sen{c}",
            "rotation": [1.0, 0, 0, 0], "translation": [c * 0.1, 0, 1.5],
            "camera_intrinsic": [[1266.4, 0, 816.3], [0, 1266.4, 491.5],
                                 [0, 0, 1]]})
    for s in range(2):
        rows["scene"].append({"token": f"scene{s}", "name": f"scene-{s}"})
        for k in range(2):
            tok = f"s{s}{k}"
            rows["sample"].append({"token": tok, "scene_token": f"scene{s}",
                                   "timestamp": 1000 * (2 * s + k)})
            for c, ch in enumerate(("LIDAR_TOP",) + CAM_NAMES):
                rows["ego_pose"].append({
                    "token": f"ep{tok}{c}", "rotation": [1.0, 0, 0, 0],
                    "translation": [4.0 * k + 0.01 * c, 0, 0]})
                rows["sample_data"].append({
                    "token": f"sd{tok}{c}", "sample_token": tok,
                    "is_key_frame": True, "calibrated_sensor_token": f"cs{c}",
                    "ego_pose_token": f"ep{tok}{c}",
                    "filename": f"samples/{ch}/{tok}.jpg"})
    os.makedirs(os.path.join(root, version))
    for name, table in rows.items():
        with open(os.path.join(root, version, f"{name}.json"), "w") as f:
            json.dump(table, f)
    return version


def test_host_clis_equal_jax(tmp_path, monkeypatch, capsys):
    """``create_data``'s infos, ``vis``'s BEV image and ``analyze_logs``'s
    table are the JAX package's."""
    import json
    import sys

    from dhd_tpu.cli import analyze_logs as j_logs
    from dhd_tpu.cli import create_data as j_create
    from dhd_tpu.cli import vis as j_vis
    from dhd_tpu_torch.cli import analyze_logs, create_data, vis

    version = _nuscenes_tables(str(tmp_path))
    got = create_data.build_infos(str(tmp_path), version)
    assert got == j_create.build_infos(str(tmp_path), version)
    assert sum(len(v) for v in got.values()) == 4
    for tok in ("scene0", "scene-7", "abc"):
        assert create_data.fallback_is_val(tok) == j_create.fallback_is_val(
            tok)

    rng = np.random.default_rng(0)
    occ = np.where(rng.random((20, 20, 16)) < 0.1,
                   rng.integers(0, 17, (20, 20, 16)), 17).astype(np.uint8)
    np.testing.assert_array_equal(vis.occ_to_bev_rgb(occ),
                                  j_vis.occ_to_bev_rgb(occ))

    log = tmp_path / "metrics.jsonl"
    log.write_text("".join(json.dumps(
        {"epoch": e, "step": s, "loss_total": 1.0 / s, "lr": 1e-4,
         "samples_per_sec": 10.0 + s}) + "\n"
        for e, s in ((0, 1), (0, 2), (1, 3))))
    outs = []
    for mod in (analyze_logs, j_logs):
        monkeypatch.setattr(sys, "argv", ["analyze_logs", "time", str(log)])
        mod.main()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 3
