"""The port's nvcc build (dhd_tpu_torch.ops.cuda_build) on the CPU: what it
builds and under which name, without nvcc."""
import hashlib
import shutil

import pytest

from dhd_tpu_torch.ops import cuda_build


def test_sources_are_every_cuda_file():
    """SOURCES names every ``csrc/*.cu``, so that one build covers them."""
    on_disk = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    assert sorted(cuda_build.SOURCES) == on_disk


@pytest.mark.parametrize("name", cuda_build.SOURCES)
def test_library_name_follows_the_source(name, tmp_path, monkeypatch):
    """A library is named by the hash of its source, under BUILD_DIR: an
    edited source gets a new name (and is rebuilt), an unchanged one the
    same name (and is reused)."""
    src = tmp_path / f"{name}.cu"
    shutil.copy(cuda_build.CSRC / f"{name}.cu", src)
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    first = cuda_build._lib_path(name)
    assert first == cuda_build.BUILD_DIR / f"lib{name}_{digest}.so"
    assert cuda_build._lib_path(name) == first
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda_build._lib_path(name) != first
