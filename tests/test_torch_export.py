"""Export in the port (``dhd_tpu_torch.cli.export``) on the CPU: dhd_tiny's
argmax program, fp32 and bf16, as the program + weights split and with
the weights baked in, written with ``torch.export.save`` and loaded fresh
with ``torch.export.load``: the loaded program's voxel classes equal the
live model's on a batch of another rig (``varied_rig``); the split
program holds no weights.  From JAX's weights the fp32 program agrees with
JAX's argmax (``dhd_tpu/cli/export.py``'s ``infer``) on at least 99.9% of
voxels, the share the port's serving holds.  Then ``cli/export`` and
``cli/benchmark --what exported`` end to end through ``main(argv)``.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu.config import get_config as j_config
from dhd_tpu.models import build_model as j_build_model
from dhd_tpu_torch.cli import benchmark, export
from dhd_tpu_torch.config import get_config
from dhd_tpu_torch.data import synthetic_batch
from dhd_tpu_torch.io import load_jax_variables
from dhd_tpu_torch.models import build_model

ARGMAX_MIN = 0.999


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: under the test lane's parallel
    workers the models' many small ops otherwise stall on the other
    workers' OpenMP threads (tests/test_torch_eval.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_tiny():
    """dhd_tiny's JAX variables and JAX's argmax on a varied-rig batch."""
    cfg = get_config("dhd_tiny")
    batch = synthetic_batch(cfg, 1, seed=5, with_gt=False, varied_rig=True)
    jmodel = j_build_model(j_config("dhd_tiny"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), jb)
    occ = jax.jit(lambda v, b: jnp.argmax(jmodel.apply(
        v, b, train=False)["occ_logits"], -1).astype(jnp.uint8))(
        variables, jb)
    return (jax.tree_util.tree_map(np.asarray, variables), batch,
            np.asarray(occ))


@pytest.fixture(scope="module", params=[("float32", "split"),
                                        ("float32", "baked"),
                                        ("bfloat16", "split"),
                                        ("bfloat16", "baked")],
                ids=lambda p: "-".join(p))
def exported(request, jax_tiny, tmp_path_factory):
    """dhd_tiny (JAX's weights) exported, saved and loaded fresh."""
    dtype, variant = request.param
    cfg = get_config("dhd_tiny")
    model = build_model(cfg, dtype=getattr(torch, dtype), device="cpu")
    load_jax_variables(model, jax_tiny[0], cfg)
    example = synthetic_batch(cfg, 1, seed=0, with_gt=False)
    keys = sorted(example)
    ep, live = export.export_program(
        model, export.batch_inputs(example, keys, "cpu"),
        bake=variant == "baked")
    path = str(tmp_path_factory.mktemp("exp") / "tiny.pt2")
    meta = {"preset": "dhd_tiny", "batch_size": 1, "inputs": keys,
            "device": "cpu", "dtype": dtype, "int8": False,
            "split": variant == "split"}
    export.save_program(ep, path, meta,
                        model.state_dict() if variant == "split" else None)
    fn, got_meta = export.load_program(path)
    assert got_meta == meta
    return dtype, variant, model, ep, path, fn, keys, live


def test_loaded_program_gives_the_live_argmax(exported, jax_tiny):
    """On the example batch and on another rig's batch the loaded
    program's classes equal the live model's (uint8, (B, Dx, Dy, Dz)); in
    fp32, from JAX's weights, they agree with JAX's export function's
    argmax on at least ARGMAX_MIN of the voxels (JAX's bf16 forward rounds
    differently: tests/test_torch_bn_fp32.py holds the bf16 forward)."""
    dtype, variant, model, _, _, fn, keys, live = exported
    cfg = get_config("dhd_tiny")
    example = synthetic_batch(cfg, 1, seed=0, with_gt=False)
    _, batch, jax_occ = jax_tiny
    with torch.no_grad():
        got0 = fn(export.batch_inputs(example, keys, "cpu"))
        got = fn(export.batch_inputs(batch, keys, "cpu"))
        want = model(batch)["occ_logits"].argmax(-1).to(torch.uint8)
    vt = cfg.vt
    assert got.dtype == torch.uint8
    assert got.shape == (1, vt.x.size, vt.y.size, vt.z_fine.size)
    assert torch.equal(got0, live)
    assert torch.equal(got, want)
    if dtype == "float32":
        assert (got.numpy() == jax_occ).mean() >= ARGMAX_MIN


def test_split_program_holds_no_weights(exported):
    dtype, variant, model, ep, path, *_ = exported
    if variant == "baked":
        assert len(ep.state_dict) == len(model.state_dict())
        return
    assert len(ep.state_dict) == 0
    assert os.path.getsize(path) < os.path.getsize(path + ".weights.pt")
    weights = torch.load(path + ".weights.pt", weights_only=True)
    assert weights.keys() == model.state_dict().keys()


def test_cli_export_and_benchmark_exported_end_to_end(tmp_path, capsys):
    """``cli/export`` (split, ``--bake-weights``, ``--bf16 --int8``) and
    ``cli/benchmark --what exported --artifact`` through ``main(argv)``
    on the CPU: the files, the printed sizes, the int8 scales' count and
    source, and a finite ms/iter."""
    out = str(tmp_path / "tiny.pt2")
    base = ["--preset", "dhd_tiny", "--device", "cpu"]
    assert export.main(base + ["--out", out]) == 0
    text = capsys.readouterr().out
    assert re.search(r"weights -> .*tiny\.pt2\.weights\.pt \([\d.]+ MB\)",
                     text)
    assert re.search(r"exported dhd_tiny -> .*tiny\.pt2 \([\d.]+ MB, "
                     r"device=cpu", text)
    baked = str(tmp_path / "baked.pt2")
    assert export.main(base + ["--out", baked, "--bake-weights"]) == 0
    assert not os.path.exists(baked + ".weights.pt")
    q = str(tmp_path / "int8.pt2")
    assert export.main(base + ["--out", q, "--bf16", "--int8",
                               "--calib-batches", "1"]) == 0
    text = capsys.readouterr().out
    assert ("calibrated 15 conv activation scales (1 synthetic batches, "
            "prefixes=('img_backbone',))") in text
    for path, what in ((out, "float32, program + weights"),
                       (baked, "float32, baked weights"),
                       (q, "bfloat16, int8, program + weights")):
        assert benchmark.main(["--what", "exported", "--artifact", path,
                               "--device", "cpu", "--iters", "2"]) == 0
        text = capsys.readouterr().out
        m = re.search(rf"dhd_tiny exported artifact \({re.escape(what)}\): "
                      rf"([\d.]+) ms/iter = ([\d.]+) samples/s", text)
        assert m and np.isfinite(float(m.group(1))), text
    with pytest.raises(SystemExit, match="--artifact"):
        benchmark.main(["--what", "exported", "--device", "cpu"])
