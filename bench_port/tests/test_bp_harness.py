"""The harness on the CPU at small configurations: the three loop kinds
through the internal entry ``harness.run_cell`` (the command line offers
no CPU run), the result's keys and types, the planted faults and the fp8
control reading false, no result without a card, and a configuration, a
mix and a metric found by name from files added beside the others."""
from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys

import pytest
import torch

import bp_helpers as H

from bench_port import harness
from bench_port.control import control_numbers
from bench_port.loops import loop_for

SEED = 2 ** 31 + 977            # more than 32 signed bits hold
CELLS = ["dhd_l.stream", "dhd_s.serve", "dhd_l.train"]
FAULTS = {"dhd_l.stream": ["state_unchanged", "answer_altered"],
          "dhd_s.serve": ["answer_altered"],
          "dhd_l.train": ["state_unchanged", "half_batch"]}


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_run_gives_the_result_keys(workload, trace):
    cell = H.small_cell(workload)
    r = harness.run_cell(cell, SEED, 0.3, trace, H.CPU, log=H.quiet)
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == set(cell.limits)
    for c in r["checks"].values():
        assert _number(c["value"]) and _number(c["limit"])
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert _number(m["value"]) and isinstance(m["unit"], str)
    dev = r["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        assert len(r["breakdown"]["device_ops"]) <= 10
    json.dumps(r)


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in FAULTS[w]])
def test_a_planted_fault_reads_false(workload, fault):
    cell = H.small_cell(workload)
    r = harness.run_cell(cell, SEED, 0.3, False, H.CPU, fault=fault,
                         log=H.quiet)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_fp8_control_reads_false(workload):
    cell = H.small_cell(workload)
    numbers = control_numbers(loop_for(cell.config, cell.traffic, SEED,
                                       H.CPU))
    assert harness.judge(numbers, cell.limits)[1] is False, numbers


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "dhd_s.serve",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    p = _run_py(H.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(H.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(H.ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _digests(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_config_mix_and_metric_are_files(tmp_path):
    here = tmp_path / "bench_port"
    shutil.copytree(H.ROOT / "bench_port", here,
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    before = _digests(here)
    spec = json.loads((H.ROOT / "BENCHMARK.json").read_text())
    cfg = H.get_config("dhd_micro")
    (here / "configs" / "micro.json").write_text(json.dumps(
        H.config_file(cfg, "dhd_micro")))
    (here / "traffic" / "serve_slow.json").write_text(json.dumps(
        {"loop": "serve", "image_pool": 2, "warm_frames": 1,
         "compared_frames": 2, "traced_items": 1, "detail_items": 1,
         "weight_gain": 2.0,
         "control_frames": 4}))
    (here / "metrics" / "frames_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.items)\n")
    (here / "limits" / "micro.serve_slow.json").write_text(json.dumps(
        {"worst_gap": 1.0, "flip_share": 1.0}))
    spec["workloads"].append({"name": "micro.serve_slow", "config": "micro",
                              "traffic": "serve_slow", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_p95_ms"):
            m["workloads"].append("micro.serve_slow")
    spec["per_layer"].append({"name": "frames_traced", "unit": "frames",
                              "better": "higher", "source": "device_trace",
                              "layer": "harness", "moves": "frame_ms",
                              "workloads": ["micro.serve_slow"]})
    cell = harness.Cell(spec, "micro.serve_slow", here=here)
    r = harness.run_cell(cell, SEED, 0.2, True, H.CPU, log=H.quiet)
    assert r["metrics"]["frames_traced"]["value"] == 1.0
    r = harness.run_cell(cell, SEED, 0.2, False, H.CPU, log=H.quiet)
    assert set(r["metrics"]) == {"frame_ms", "frame_p95_ms", "peak_mem_gb",
                                 "setup_s"}
    after = _digests(here)
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.cuda
def test_the_control_on_the_card():
    """The fp8 control at a small configuration on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the chip")
    dev = torch.device("cuda")
    for workload in CELLS:
        cell = H.small_cell(workload)
        numbers = control_numbers(loop_for(cell.config, cell.traffic, SEED,
                                           dev))
        assert any(numbers[k] > v for k, v in cell.limits.items())
