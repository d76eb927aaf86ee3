"""The port's training CLI (dhd_tpu_torch.cli.train) in-process on the
CPU: two synthetic steps write metrics.jsonl and a checkpoint, a resume
continues from it, the unported flags exit 1 naming ROADMAP.md, and
without ``--device`` and without a GPU it raises."""
import json

import pytest
import torch

from dhd_tpu_torch.cli.train import main
from dhd_tpu_torch.config import get_config
from dhd_tpu_torch.io import load_checkpoint
from dhd_tpu_torch.models import build_model
from dhd_tpu_torch.train import AdamWSchedule, ModelEMA

ARGS = ["--preset", "dhd_tiny", "--synthetic", "--device", "cpu",
        "--log-interval", "1"]


def test_two_steps_write_metrics_and_a_checkpoint(tmp_path, capsys):
    assert main(ARGS + ["--steps", "2", "--work-dir", str(tmp_path)]) == 0
    rows = [json.loads(ln) for ln in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert {"loss_total", "loss_height", "loss_occ", "loss_voxel_sem_scal",
            "loss_voxel_geo_scal", "grad_norm"} <= set(rows[0])
    out = capsys.readouterr().out
    assert "saved checkpoint" in out and "training done" in out
    cfg = get_config("dhd_tiny")
    model = build_model(cfg, device="cpu")
    opt = AdamWSchedule(model.parameters(), cfg.optim)
    ema = ModelEMA(model, cfg.optim.ema_init_updates)
    assert load_checkpoint(tmp_path / "epoch_1.pt", model, opt, ema) == 2
    assert opt.count == 2 and ema.updates == cfg.optim.ema_init_updates + 2


def test_log_interval_holds_with_steps_and_the_last_step_logs(tmp_path):
    """``--steps`` logs every ``--log-interval`` steps and the last one,
    not every step (each log reads the metrics back to the host)."""
    assert main(ARGS + ["--steps", "3", "--log-interval", "2",
                        "--work-dir", str(tmp_path)]) == 0
    rows = [json.loads(ln) for ln in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [2, 3]


def test_auto_resume_continues_from_the_newest_checkpoint(tmp_path, capsys):
    wd = str(tmp_path)
    assert main(ARGS + ["--steps", "1", "--work-dir", wd]) == 0
    assert main(ARGS + ["--steps", "2", "--work-dir", wd,
                        "--auto-resume"]) == 0
    out = capsys.readouterr().out
    assert "auto-resuming from" in out and "epoch_1.pt" in out
    rows = [json.loads(ln) for ln in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["epoch"], r["step"]) for r in rows] == [(0, 1), (1, 2)]
    assert (tmp_path / "epoch_2.pt").exists()


@pytest.mark.parametrize("flag", [["--ann-file", "infos.pkl"]])
def test_unported_flags_exit_naming_the_roadmap(flag):
    with pytest.raises(SystemExit) as e:
        main(ARGS + flag)
    assert "ROADMAP.md" in str(e.value.code)


def test_multi_device_exits_naming_the_roadmap(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        main(ARGS)


def test_raises_without_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--preset", "dhd_tiny", "--synthetic", "--steps", "1"])
