"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test here needs a CUDA device and skips without one.
No JAX here: on the GPU machine run
``python -m pytest --noconftest tests/test_torch_cuda.py -q``."""
import numpy as np
import pytest
import torch

from dhd_tpu_torch.config import GridConfig, ViewTransformConfig
from dhd_tpu_torch.ops import (build_pool_plan, compute_pool_indices,
                               mghs_pool_cuda, mghs_pool_plan_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _pool_inputs(dev, dtype, seed=6):
    """The tiny grid of tests/test_voxel_pool.py with random points, some
    outside the grid, and random band gates."""
    vt = ViewTransformConfig(input_size=(32, 64), downsample=16,
                             depth=GridConfig(1.0, 9.0, 1.0),
                             x=GridConfig(-4.0, 4.0, 0.4),
                             y=GridConfig(-4.0, 4.0, 0.4), out_channels=8)
    rng = np.random.default_rng(seed)
    b, n, (fh, fw) = 2, 2, vt.feat_size
    coords = rng.uniform(-5.0, 5.0, (b, n, vt.D, fh, fw, 3))
    coords[..., 2] = rng.uniform(-2.0, 6.0, coords[..., 2].shape)
    plan = build_pool_plan(compute_pool_indices(
        torch.tensor(coords, dtype=torch.float32, device=dev), vt),
        vt, (b, n, vt.D, fh, fw))
    band = rng.integers(0, 4, (b, n, fh, fw))
    args = [rng.random((b, n, fh, fw, vt.D)),
            rng.normal(0, 1, (b, n, fh, fw, vt.out_channels)),
            np.stack([band == k for k in range(3)], axis=-1)]
    return [torch.tensor(a, dtype=dtype, device=dev) for a in args], plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mghs_pool_kernel_matches_plain(cuda, dtype):
    """fp32 within 1e-5; bf16 within one bf16 ulp (2^-7 relative): only
    the fp32 summation order differs."""
    args, plan = _pool_inputs(cuda, dtype)
    before = mghs_pool_cuda.launches
    got = mghs_pool_cuda(*args, plan)
    assert mghs_pool_cuda.launches == before + 1
    want = mghs_pool_plan_plain(*args, plan)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        g, w = g.float(), w.float()
        tol = 1e-5 if dtype == torch.float32 else 2 ** -7 * w.abs()
        assert bool(((g - w).abs() <= tol).all())
        assert float(w.abs().sum()) > 0


def test_mghs_pool_kernel_rejects_bad_inputs(cuda):
    (depth, feat, band_mask), plan = _pool_inputs(cuda, torch.float32)
    before = mghs_pool_cuda.launches
    with pytest.raises(ValueError, match="depth"):
        mghs_pool_cuda(depth.transpose(0, 1), feat, band_mask, plan)
    with pytest.raises(ValueError, match="band_mask"):
        mghs_pool_cuda(depth, feat, band_mask.double(), plan)
    with pytest.raises(TypeError):
        mghs_pool_cuda(depth.half(), feat.half(), band_mask.half(), plan)
    assert mghs_pool_cuda.launches == before
