"""The PyTorch port imports nothing of JAX, flax or the JAX package."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "dhd_tpu")
SOURCES = sorted((ROOT / "dhd_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py", ROOT / "chip_variants.py"]


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
            "dhd_tpu_torch/ops/segment_sum.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
