"""The benchmark measures the port alone: no module under ``bench_port/``
imports JAX, flax or the JAX package, and the plain reference imports
nothing of the port.  Top-level names are compared whole:
``dhd_tpu_torch`` is not ``dhd_tpu``."""
import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted(BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "dhd_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_found():
    names = {p.relative_to(BENCH).as_posix() for p in SOURCES}
    assert {"run.py", "harness.py", "loops.py", "reference/models/dhd.py",
            "metrics/mfu.train.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(BENCH)} imports {bad}"


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.parts],
    ids=[str(p.relative_to(BENCH)) for p in SOURCES
         if "reference" in p.parts])
def test_reference_imports_nothing_of_the_port(path):
    bad = [m for m in _imports(path) if m.split(".")[0] == "dhd_tpu_torch"]
    assert not bad, f"{path.relative_to(BENCH)} imports {bad}"


def test_the_check_compares_whole_names():
    from bench_port.harness import FORBIDDEN as RUN_FORBIDDEN
    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert "dhd_tpu_torch".split(".")[0] not in RUN_FORBIDDEN
