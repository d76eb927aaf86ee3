"""The PyTorch port imports nothing of JAX, flax or the JAX package: nor
do the scripts beside it, nor the test modules the card runs without JAX
(``--noconftest``) and the helpers they import."""
import ast
import pathlib

import pytest

from chip_smoke import CARD_MODULES

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "dhd_tpu")
SOURCES = sorted((ROOT / "dhd_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_variants.py"] + [
    ROOT / name for name in CARD_MODULES] + [ROOT / "tests" / "torch_cases.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_found():
    assert len(SOURCES) > 10
    assert all(p.exists() for p in SOURCES)
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"dhd_tpu_torch/cli/benchmark.py", "dhd_tpu_torch/profiling.py",
            "dhd_tpu_torch/ops/segment_sum.py", "dhd_tpu_torch/cli/test.py",
            "dhd_tpu_torch/eval/rayiou.py", "dhd_tpu_torch/ops/dvr.py",
            "dhd_tpu_torch/data/pipeline.py",
            "dhd_tpu_torch/native/__init__.py",
            "dhd_tpu_torch/nn/quant.py", "dhd_tpu_torch/cli/export.py",
            "dhd_tpu_torch/parallel/mesh.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_smoke_runs_every_card_module():
    """``chip_smoke.py`` runs every test module of the port that holds a
    ``cuda``-marked test, and no other."""
    marked = {p.relative_to(ROOT).as_posix()
              for p in (ROOT / "tests").glob("test_torch_*.py")
              if p.name != pathlib.Path(__file__).name
              and "pytest.mark.cuda" in p.read_text()}
    assert marked == set(CARD_MODULES)
