"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test here needs a CUDA device and skips without one.
No JAX here: on the GPU machine run
``python -m pytest --noconftest tests/test_torch_cuda.py -q``."""
import numpy as np
import pytest
import torch

from dhd_tpu_torch.config import GridConfig, ViewTransformConfig
from dhd_tpu_torch.geometry import create_frustum
from dhd_tpu_torch.ops import (build_cv_plan, build_pool_plan,
                               compute_pool_indices, cv_cost_plain,
                               mghs_pool_cuda, mghs_pool_plan_plain,
                               stereo_cost_volume_cuda)

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


def _cv_inputs(dev, dtype, c, seed=3, bn=2, hs=16, ws=40):
    """A rig with ~1 deg of yaw and a forward step, rectified features
    (exact zeros, as after a ReLU) and the plan of 16 depth bins."""
    rng = np.random.default_rng(seed)
    intr = np.zeros((1, bn, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = ws * 4 * 0.8
    intr[..., 0, 2], intr[..., 1, 2], intr[..., 2, 2] = ws * 2, hs * 2, 1.0
    k2s = np.broadcast_to(np.eye(4, dtype=np.float32), (1, bn, 4, 4)).copy()
    th = rng.uniform(-0.02, 0.02, bn)
    k2s[0, :, 0, 0] = k2s[0, :, 2, 2] = np.cos(th)
    k2s[0, :, 0, 2], k2s[0, :, 2, 0] = np.sin(th), -np.sin(th)
    k2s[0, :, :3, 3] = rng.uniform(-0.3, 0.3, (bn, 3))
    k2s[0, :, 2, 3] = 0.5
    frustum = create_frustum(GridConfig(1.0, 9.0, 0.5), (hs * 4, ws * 4), 4,
                             device=dev)
    t = lambda a: torch.tensor(a, device=dev)
    uf, vf = build_cv_plan(frustum, t(k2s), t(intr),
                           torch.eye(3, device=dev).expand(1, bn, 3, 3),
                           torch.zeros(1, bn, 3, device=dev), hs, ws)
    feats = [torch.relu(torch.tensor(rng.normal(0, 1, (bn, hs, ws, c)),
                                     dtype=dtype, device=dev))
             for _ in range(2)]
    return feats[0], feats[1], uf, vf


@pytest.mark.parametrize("dtype,c", [(torch.float32, 8), (torch.float32, 256),
                                     (torch.bfloat16, 256),
                                     (torch.bfloat16, 512)])
def test_cost_volume_kernel_matches_plain(cuda, dtype, c):
    """B3 against its plain version on the same inputs: both upcast to fp32
    and differ only in the order of the channel sum; the bias lands on the
    same samples (exact zeros in channel 0 included)."""
    prev, curr, uf, vf = _cv_inputs(cuda, dtype, c)
    before = stereo_cost_volume_cuda.launches
    got = stereo_cost_volume_cuda(prev, curr, uf, vf, 5.0)
    assert stereo_cost_volume_cuda.launches == before + 1
    want = cv_cost_plain(prev, curr, uf, vf, 5.0)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (prev.shape[0], 16) + prev.shape[1:3]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * c ** 0.5)
    no_bias = cv_cost_plain(prev, curr, uf, vf, 0.0)
    hit = (want - no_bias) > 2.5
    assert bool(((got - no_bias > 2.5) == hit).all())
    assert bool((hit & (uf > -1e3)).any()) and bool((~hit).any())
    torch.testing.assert_close(torch.softmax(-got, 1),
                               torch.softmax(-want, 1), atol=2e-5, rtol=1e-4)


def test_cost_volume_kernel_rejects_bad_inputs(cuda):
    prev, curr, uf, vf = _cv_inputs(cuda, torch.float32, 8)
    before = stereo_cost_volume_cuda.launches
    with pytest.raises(ValueError, match="curr"):
        stereo_cost_volume_cuda(prev, curr.transpose(1, 2), uf, vf)
    with pytest.raises(ValueError, match="uf"):
        stereo_cost_volume_cuda(prev, curr, uf.double(), vf)
    with pytest.raises(ValueError, match="C=6"):
        stereo_cost_volume_cuda(prev[..., :6].contiguous(),
                                curr[..., :6].contiguous(), uf, vf)
    with pytest.raises(TypeError):
        stereo_cost_volume_cuda(prev.half(), curr.half(), uf, vf)
    wide = prev.repeat(1, 1, 1, 33)                  # C=264 > 256 in fp32
    with pytest.raises(ValueError, match="C=264"):
        stereo_cost_volume_cuda(wide, wide, uf, vf)
    assert stereo_cost_volume_cuda.launches == before
