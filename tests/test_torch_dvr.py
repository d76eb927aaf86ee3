"""The port's differentiable volume renderer (dhd_tpu_torch.ops.dvr) against
the JAX package's ``render`` and against the scalar restatement of the
reference CUDA kernel, ``_oracle_render`` of tests/test_dvr.py, with
padded, missed and truncated rays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu.ops import render as j_render
from dhd_tpu_torch.ops.dvr import render, render_expected_depth
from tests.test_dvr import _fixture, _oracle_render

# the port against JAX (both fp32, the sums in another order): forward
# 2.4e-7 and gradients 1.4e-6 at most on these fixtures; the oracle bars
# are tests/test_dvr.py's own
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
ORACLE_FWD = dict(rtol=2e-4, atol=2e-4)
ORACLE_GRAD = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: under the test lane's parallel
    workers, thousands of small ops (the DDA loops) otherwise stall on the
    other workers' OpenMP threads (~40x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(case, loss, steps=64):
    j = [np.asarray(a) for a in j_render(*map(jnp.asarray, case), loss,
                                         steps)]
    t = [a.numpy() for a in render(*map(torch.from_numpy, case), loss,
                                   steps)]
    return t, j


@pytest.mark.parametrize("loss", ["l1", "l2", "absrel"])
@pytest.mark.parametrize("seed", [0, 3])
def test_render_matches_jax_and_the_cuda_oracle(loss, seed):
    case = _fixture(seed=seed)
    case[3][0, ::3] = -1                       # more padded rays
    (pred, gt, grad), (jp, jg, jgrad) = _both(case, loss)
    np.testing.assert_allclose(pred, jp, **JAX_TOL)
    np.testing.assert_array_equal(gt, jg)
    np.testing.assert_allclose(grad, jgrad, **JAX_TOL)
    ep, eg, egrad = _oracle_render(*case, loss)
    np.testing.assert_allclose(pred, ep, **ORACLE_FWD)
    np.testing.assert_allclose(gt, eg, **ORACLE_FWD)
    np.testing.assert_allclose(grad, egrad, **ORACLE_GRAD)
    assert (pred[case[3] < 0] == -1).all() and (pred[case[3] >= 0] > 0).all()


def test_padded_and_missed_rays_give_minus_one_and_no_gradient():
    sigma, origin, points, tindex = _fixture(seed=5)
    tindex[:] = -1
    pred, gt, grad = render(*map(torch.from_numpy,
                                 (sigma, origin, points, tindex)), "l2", 64)
    assert (pred == -1).all() and (gt == -1).all() and (grad == 0).all()
    # rays from outside the grid that never reach it
    sigma, origin, points, tindex = _fixture(seed=6, n=1, t=1, m=8)
    tindex[:] = 0
    origin[:] = np.array([-20.0, -20.0, -20.0], np.float32)
    points[:] = np.array([-25.0, -20.0, -20.0], np.float32)
    (pred, gt, grad), (jp, jg, _) = _both(
        (sigma, origin, points, tindex), "l1")
    assert (pred == -1).all() and (jp == -1).all() and (grad == 0).all()


def test_truncated_rays_are_invalid_as_in_jax():
    """Rays still walking in-grid when the step budget runs out stay -1."""
    case = _fixture(seed=8, n=1, t=1, m=24)
    (pred, gt, grad), (jp, jg, jgrad) = _both(case, "l1", steps=3)
    np.testing.assert_array_equal(pred == -1, jp == -1)
    assert (pred == -1).sum() > (case[3] < 0).sum()
    np.testing.assert_allclose(pred, jp, **JAX_TOL)
    np.testing.assert_allclose(grad, jgrad, **JAX_TOL)


def test_render_expected_depth_is_differentiable():
    sigma, origin, points, tindex = _fixture(seed=7, n=1, t=1, m=16)
    s = torch.from_numpy(sigma).requires_grad_(True)
    pred, gt, valid = render_expected_depth(
        s, *map(torch.from_numpy, (origin, points, tindex)), 64)
    torch.where(valid, (pred - gt) ** 2, 0.0).sum().backward()
    assert torch.isfinite(s.grad).all() and s.grad.abs().sum() > 0


def test_render_under_inference_mode_and_bad_loss():
    case = [torch.from_numpy(a) for a in _fixture(seed=9, n=1, m=8)]
    with torch.inference_mode():
        _, _, grad = render(*case, "l2", 64)
    assert grad.abs().sum() > 0
    with pytest.raises(ValueError, match="loss_name"):
        render(*case, "huber")
