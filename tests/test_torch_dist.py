"""Data parallelism in the port (``dhd_tpu_torch.parallel``) on the CPU:
two gloo processes against one.

The JAX package's sharded step *is* its single-device step over the
global batch (GSPMD makes every BatchNorm a SyncBN and every loss a
global one), and tests/test_torch_train.py holds the port's one-process
step against JAX's.  So the two-process step is held against the
one-process step over the same global batch of 4 (dhd_tiny, ASPP dropout
on): the losses and grad_norm within 1e-5 relative, the parameters and
the EMA within rtol 1e-5 plus 1e-6, and the BatchNorm statistics within
1e-5 of each tensor's peak plus 2^-20 of the terms the one-pass variance
subtracts (a tenth of the channel's E[x^2], the momentum's share): the
camera embedding's BatchNorm sees intrinsics of ~557 px, whose x^2 sums
cancel to a variance near 0, where the two sum orders differ by a
fraction of an fp32 ulp of 3e5.  Each spawned group has a timeout.
"""
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as W
from dhd_tpu_torch import parallel
from dhd_tpu_torch.config import get_config
from dhd_tpu_torch.models import build_model

SPAWN_TIMEOUT_S = 240
RTOL = 1e-5
TERMS = 2.0 ** -20


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: under the test lane's parallel
    workers the models' many small ops otherwise stall on the other
    workers' OpenMP threads (tests/test_torch_eval.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(fn, *args, world=2):
    """``fn(rank, world, port, *args)`` in ``world`` spawned processes;
    fails if they do not all end within SPAWN_TIMEOUT_S."""
    ctx = mp.start_processes(fn, args=(world, _free_port()) + args,
                             nprocs=world, join=False,
                             start_method="spawn")
    deadline = SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        deadline -= 5
        if deadline <= 0:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__} did not end in {SPAWN_TIMEOUT_S} s")


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """One train step of dhd_tiny over a global batch of 4: in this
    process, and as two gloo processes of 2 rows each."""
    out = str(tmp_path_factory.mktemp("dist") / "state")
    ref = W.train_state("dhd_tiny", 4, 1)
    _spawn(W.run_train, "dhd_tiny", 4, 1, out)
    return ref, [torch.load(f"{out}.{r}") for r in range(2)]


def _param_names():
    return {k for k, _ in build_model(get_config("dhd_tiny"),
                                      device="cpu").named_parameters()}


def test_two_processes_give_the_losses_and_grad_norm(steps):
    ref, got = steps
    for name, want in ref["metrics"][0].items():
        assert abs(got[0]["metrics"][0][name] - want) <= RTOL * abs(want), \
            (name, got[0]["metrics"][0][name], want)


def test_two_processes_give_the_parameters_and_ema(steps):
    ref, got = steps
    names = _param_names()
    for key in ("state", "ema"):
        for k in names:
            np.testing.assert_allclose(got[0][key][k].numpy(),
                                       ref[key][k].numpy(), rtol=RTOL,
                                       atol=1e-6, err_msg=f"{key} {k}")


def test_two_processes_give_the_batchnorm_statistics(steps):
    """SyncBN: every running mean and variance (and their EMA) stepped
    with the global batch's statistics."""
    ref, got = steps
    n = 0
    for key in ("state", "ema"):
        for k, want in ref[key].items():
            if not k.endswith(("running_mean", "running_var")):
                continue
            bn = k.rsplit(".", 1)[0]
            m2 = ref["second"][bn]
            terms = 0.1 * (m2 if k.endswith("var") else m2.sqrt())
            tol = RTOL * want.abs().max() + TERMS * terms
            err = (got[0][key][k] - want).abs()
            assert bool((err <= tol).all()), (key, k, float(err.max()))
            n += 1
    assert n == 4 * len(ref["second"])


def test_the_processes_agree_bit_for_bit(steps):
    """Both ranks hold the same model, moments and EMA after the step."""
    _, (a, b) = steps
    for key in ("state", "moments", "ema"):
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    assert a["metrics"] == b["metrics"]


def test_global_rand_draws_per_global_sample(steps):
    """Rank r's rows of a global draw are rows [2r, 2r + 2) of the one
    process's draw of all four (the dropout and DropPath masks)."""
    _, got = steps
    want = torch.rand((4, 3), generator=torch.Generator().manual_seed(0))
    for r in range(2):
        assert torch.equal(got[r]["draw"], want[2 * r:2 * r + 2])


def test_without_a_group_every_helper_is_the_identity(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not parallel.initialize_distributed("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not parallel.initialize_distributed("cpu")
    assert not parallel.is_distributed()
    assert (parallel.world_size(), parallel.rank()) == (1, 0)
    assert parallel.process_batch_slice(4) == slice(0, 4)
    batch = {"a": np.arange(8).reshape(4, 2)}
    np.testing.assert_array_equal(parallel.shard_batch(batch)["a"],
                                  batch["a"])
    t = torch.arange(3.0, requires_grad=True)
    assert parallel.global_sums(t, t)[1] is t
    assert parallel.gather_objects("x") == ["x"]
    g = torch.Generator().manual_seed(5)
    want = torch.rand((2, 3), generator=torch.Generator().manual_seed(5))
    assert torch.equal(parallel.global_rand((2, 3), g, "cpu"), want)


def test_cli_test_over_two_processes_gives_the_one_process_metrics(
        tmp_path, capsys):
    """``cli/test --synthetic`` with two batches: one a process, the
    confusion matrices summed; rank 0 prints what one process prints."""
    from dhd_tpu_torch.cli.test import main

    argv = ["--preset", "dhd_tiny", "--synthetic", "--device", "cpu"]
    assert main(argv) == 0
    want = capsys.readouterr().out
    out = str(tmp_path / "test")
    _spawn(W.run_cli_test, argv, out)
    texts = [open(f"{out}.{r}").read() for r in range(2)]
    assert texts[0] == "rc=0\n" + want
    assert texts[1] == "rc=0\n"
    assert "evaluated 2 samples" in want and "===> mIoU: " in want


def test_cli_train_over_two_processes(tmp_path, capsys):
    """``cli/train --synthetic --batch-size 4`` as two processes: the
    one-process run's losses, one log and one checkpoint, both written
    by rank 0."""
    from dhd_tpu_torch.cli.train import main

    def argv(wd):
        return ["--preset", "dhd_tiny", "--synthetic", "--steps", "1",
                "--batch-size", "4", "--device", "cpu", "--work-dir",
                str(wd), "--log-interval", "1"]
    assert main(argv(tmp_path / "one")) == 0
    one = capsys.readouterr().out
    out = str(tmp_path / "train")
    _spawn(W.run_cli_train, argv(tmp_path / "two"), out)
    texts = [open(f"{out}.{r}").read() for r in range(2)]
    assert texts[1] == "rc=0\n"
    assert "and 1 more processes (2 rows each)" in texts[0]
    assert "training done" in texts[0]

    def losses(text):
        line = next(ln for ln in text.splitlines() if "loss_total=" in ln)
        return dict(kv.split("=") for kv in line.split(") ")[1].split())
    got, want = losses(texts[0]), losses(one)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= \
            1e-4 * abs(float(want[k])) + 1e-4, (k, got[k], want[k])
    assert sorted(os.listdir(tmp_path / "two")) == ["epoch_1.pt",
                                                    "metrics.jsonl"]
    assert len((tmp_path / "two" / "metrics.jsonl").read_text()
               .splitlines()) == 1
