"""The port's stereo geometry, warp and cost volume (dhd_tpu_torch.geometry
.rigid, dhd_tpu_torch.ops.{warp,cost_volume,cost_volume_cuda}) against the
JAX package's, in fp32 on the CPU, where the cost-volume wrapper takes its
plain version.  The kernel itself is held to that plain version on the card
in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu.config import GridConfig as JGridConfig
from dhd_tpu.geometry import create_frustum as j_frustum
from dhd_tpu.geometry import rigid_inverse as j_rigid_inverse
from dhd_tpu.geometry import rigid_relative as j_rigid_relative
from dhd_tpu.ops.cost_volume import stereo_cost_volume as j_cost_volume
from dhd_tpu.ops.cost_volume import stereo_reproject_grid as j_grid
from dhd_tpu.ops.cost_volume_pallas import build_cv_plan as j_cv_plan
from dhd_tpu.ops.cost_volume_pallas import (stereo_cost_volume_pallas,
                                            validate_cv_plan)
from dhd_tpu.ops.warp import grid_sample_2d as j_grid_sample
from dhd_tpu_torch.config import GridConfig
from dhd_tpu_torch.device import device_constant
from dhd_tpu_torch.geometry import (create_frustum, inverse_3x3,
                                    rigid_inverse, rigid_relative)
from dhd_tpu_torch.ops import (build_cv_plan, cv_cost_plain, grid_sample_2d,
                               stereo_cost_volume, stereo_cost_volume_cuda,
                               stereo_reproject_grid)
from dhd_tpu_torch.profiling import kernel_launches

T = torch.from_numpy


def _pose(rng, shape, trans_scale):
    """Random rigid 4x4 transforms (rotation from a QR) with translations
    of about ``trans_scale`` metres."""
    q, r = np.linalg.qr(rng.normal(0, 1, shape + (3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
    m = np.zeros(shape + (4, 4))
    m[..., :3, :3] = q
    m[..., :3, 3] = trans_scale * rng.uniform(-1, 1, shape + (3,))
    m[..., 3, 3] = 1.0
    return m


def test_rigid_helpers_cancel_1500_m_translations():
    """Two fp32 poses 1500 m from the origin and a metre apart: the
    relative transform agrees with float64 numpy on the same fp32 inputs
    to a micrometre, where a plain fp32 inv(a) @ b is off by a tenth of a
    millimetre and more."""
    rng = np.random.default_rng(0)
    a = _pose(rng, (64,), 1500.0).astype(np.float32)
    b = (a.astype(np.float64) @ _pose(rng, (64,), 1.0)).astype(np.float32)
    want = np.linalg.inv(a.astype(np.float64)) @ b.astype(np.float64)
    got = rigid_relative(T(a), T(b)).double().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got[..., 3, :], want[..., 3, :])
    naive = (torch.linalg.inv(T(a)) @ T(b)).double().numpy()
    assert np.abs(naive - want)[..., :3, 3].max() > 1e-4
    inv = rigid_inverse(T(a)).double().numpy()
    np.testing.assert_allclose(inv, np.linalg.inv(a.astype(np.float64)),
                               atol=2e-4, rtol=1e-6)
    np.testing.assert_allclose(
        inv, np.asarray(j_rigid_inverse(jnp.asarray(a))), atol=2e-4,
        rtol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(j_rigid_relative(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6)


@pytest.mark.parametrize("kind", ["intrinsics", "rotation", "general"])
def test_inverse_3x3_matches_float64(kind):
    """The closed-form 3x3 inverse of the per-frame geometry against float64
    numpy, on camera intrinsics of ~557 px, rotations and general
    well-conditioned matrices."""
    rng = np.random.default_rng(len(kind))
    if kind == "intrinsics":
        m = np.zeros((12, 3, 3))
        m[:, 0, 0] = m[:, 1, 1] = rng.uniform(400, 1300, 12)
        m[:, 0, 2], m[:, 1, 2] = rng.uniform(300, 800, (2, 12))
        m[:, 2, 2] = 1.0
    elif kind == "rotation":
        m = _pose(rng, (12,), 0.0)[:, :3, :3]
    else:
        m = rng.normal(0, 1, (12, 3, 3)) + 3 * np.eye(3)
    m = m.astype(np.float32)
    want = np.linalg.inv(m.astype(np.float64))
    got = inverse_3x3(T(m)).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_device_constant_is_shared():
    """A constant is made once per (values, device, dtype) and reused."""
    a = device_constant((1.0, 2.0), "cpu")
    assert a is device_constant([1.0, 2.0], "cpu")
    assert a.dtype == torch.float32 and a.tolist() == [1.0, 2.0]
    m = device_constant([[1, 2], [3, 4]], "cpu", torch.int64)
    assert m.shape == (2, 2) and m is not a


@pytest.mark.parametrize("c", [1, 5])
def test_grid_sample_2d_matches_jax(c):
    """Samples inside, on the borders (x or y exactly -1 or +1), just
    outside and far outside the map: zero padding, align_corners=True."""
    rng = np.random.default_rng(c)
    img = rng.normal(0, 1, (2, 7, 9, c)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 11, 2)).astype(np.float32)
    grid[:, 0, :4] = [[-1, -1], [1, 1], [-1, 1], [1, -1]]
    grid[:, 1, :3] = [[-1.2, 0.3], [0.5, 1.0001], [5.0, -7.0]]
    want = np.asarray(j_grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    got = grid_sample_2d(T(img), T(grid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got[:, 1, 2] == 0).all()                      # far outside


def test_grid_sample_2d_bf16_keeps_dtype():
    img = torch.randn(1, 6, 8, 4).to(torch.bfloat16)
    grid = torch.rand(1, 3, 5, 2) * 2 - 1
    out = grid_sample_2d(img, grid)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), grid_sample_2d(img.float(), grid),
                               atol=2e-2, rtol=1e-2)


def _geometry(b, n, h_img, w_img, seed=7, rot=True):
    """The rig of tests/test_cost_volume_pallas.py: ~1 deg of yaw and a
    forward/sideways translation between the frames."""
    rng = np.random.default_rng(seed)
    intr = np.zeros((b, n, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = w_img * 0.8
    intr[..., 0, 2] = w_img / 2.0
    intr[..., 1, 2] = h_img / 2.0
    intr[..., 2, 2] = 1.0
    post_rots = np.broadcast_to(np.eye(3, dtype=np.float32),
                                (b, n, 3, 3)).copy()
    post_trans = np.zeros((b, n, 3), np.float32)
    k2s = np.broadcast_to(np.eye(4, dtype=np.float32), (b, n, 4, 4)).copy()
    for bi in range(b):
        for ni in range(n):
            th = rng.uniform(-0.02, 0.02) if rot else 0.0
            c, s = np.cos(th), np.sin(th)
            k2s[bi, ni, :3, :3] = np.array(
                [[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            k2s[bi, ni, :3, 3] = rng.uniform(-0.3, 0.3, 3)
    return intr, post_rots, post_trans, k2s


def _case(ws, seed=3, b=1, n=2, cs=8, hs=16, depth=(1.0, 9.0, 0.5)):
    """Features, frustum and rig of one cost-volume case.  Channel 0 of
    prev is rectified, so about half its values are exact zeros: valid
    samples whose four taps all read 0 there hit the reference's
    invalid-sample test too."""
    h_img, w_img = hs * 4, ws * 4
    frustum = np.asarray(j_frustum(JGridConfig(*depth), (h_img, w_img), 4),
                         np.float32)
    np.testing.assert_array_equal(
        create_frustum(GridConfig(*depth), (h_img, w_img), 4).numpy(),
        frustum)
    rng = np.random.default_rng(seed)
    prev = rng.normal(0, 1, (b, n, hs, ws, cs)).astype(np.float32)
    prev[..., 0] = np.maximum(prev[..., 0], 0.0)
    curr = rng.normal(0, 1, (b, n, hs, ws, cs)).astype(np.float32)
    intr, post_rots, post_trans, k2s = _geometry(b, n, h_img, w_img)
    return prev, curr, frustum, k2s, intr, post_rots, post_trans


def test_stereo_reproject_grid_matches_jax():
    _, _, frustum, k2s, intr, post_rots, post_trans = _case(24)
    # one camera looks backwards: its points are behind the previous
    # camera and must come out at -2
    k2s[0, 1, :3, :3] = np.diag([-1.0, 1.0, -1.0])
    args = (frustum, k2s, intr, post_rots, post_trans)
    want = np.asarray(j_grid(*map(jnp.asarray, args), 64, 96))
    got = stereo_reproject_grid(*map(torch.tensor, args), 64, 96).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (got[0, 1] == -2.0).all()


def test_cv_plan_matches_jax_plan():
    """uf/vf equal the JAX plan's (which pads Ws to a 128-lane tile) on the
    real columns; the far sentinel marks the same samples."""
    _, _, frustum, k2s, intr, post_rots, post_trans = _case(48)
    args = (frustum, k2s, intr, post_rots, post_trans)
    jp = j_cv_plan(*map(jnp.asarray, args), 16, 48)
    uf, vf = build_cv_plan(*map(T, args), 16, 48)
    for got, want in ((uf, jp["uf"]), (vf, jp["vf"])):
        want = np.asarray(want)[..., :48]
        np.testing.assert_array_equal(got.numpy() < -1e3, want < -1e3)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("ws", [24, 48])
def test_plain_cost_volume_matches_jax_xla_and_pallas(ws):
    """The port's plain path (the CPU side of the kernel wrapper) against
    JAX's XLA gather path and its Pallas kernel in interpret mode, at the
    row window the plan needs: bias 5.0, the tolerance the Pallas kernel
    holds against XLA."""
    case = _case(ws)
    jargs = tuple(map(jnp.asarray, case))
    want = np.asarray(j_cost_volume(*jargs, bias=5.0, method="xla"))
    plan = j_cv_plan(*jargs[2:], 16, ws)
    wr = validate_cv_plan(plan)["wr_req"]
    pallas = np.asarray(stereo_cost_volume_pallas(*jargs, bias=5.0,
                                                  win_rows=wr,
                                                  interpret=True))
    got = stereo_cost_volume(*map(T, case), bias=5.0).numpy()
    assert got.shape == want.shape == pallas.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-4)
    forced = stereo_cost_volume(*map(T, case), bias=5.0, method="xla")
    np.testing.assert_array_equal(forced.numpy(), got)


def test_channel0_quirk_counts_valid_zero_samples():
    """Raw costs: every sample whose warped channel 0 is exactly 0 carries
    the bias, off-image samples and valid ones alike, and both kinds occur
    in this case."""
    prev, curr, frustum, k2s, intr, post_rots, post_trans = _case(24)
    bn, hs, ws, cs = 2, 16, 24, 8
    uf, vf = build_cv_plan(*map(T, (frustum, k2s, intr, post_rots,
                                    post_trans)), hs, ws)
    p = T(prev).reshape(bn, hs, ws, cs)
    c = T(curr).reshape(bn, hs, ws, cs)
    with_bias = cv_cost_plain(p, c, uf, vf, bias=5.0)
    no_bias = cv_cost_plain(p, c, uf, vf, bias=0.0)
    hit = (with_bias - no_bias) > 2.5
    off = uf < -1e3
    assert hit[off].all()
    assert int((hit & ~off).sum()) > 0                    # valid zeros
    assert int((~hit).sum()) > 0
    # the off-image cost is the plain sum of |curr|
    want = c.abs().sum(-1)[:, None].expand_as(no_bias)[off]
    torch.testing.assert_close(no_bias[off], want)


def test_identical_frames_give_uniform_depth():
    """Identity motion and equal features: zero cost at every visible
    bin, so the centre pixel's distribution is uniform."""
    b, n, hs, ws, c = 1, 1, 4, 8, 8
    feat = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (b, n, hs, ws, c)).astype(np.float32))
    frustum = create_frustum(GridConfig(1.0, 5.0, 1.0), (hs * 4, ws * 4), 4)
    k2s = torch.eye(4).expand(b, n, 4, 4)
    intr = torch.tensor([[[[20.0, 0, ws * 2], [0, 20.0, hs * 2],
                           [0, 0, 1.0]]]])
    cv = stereo_cost_volume(feat, feat, frustum, k2s, intr,
                            torch.eye(3).expand(b, n, 3, 3),
                            torch.zeros(b, n, 3))
    assert cv.shape == (b, n, 4, hs, ws)
    torch.testing.assert_close(cv.sum(2), torch.ones(b, n, hs, ws))
    torch.testing.assert_close(cv[0, 0, :, hs // 2, ws // 2],
                               torch.full((4,), 0.25))


def test_cuda_wrapper_on_cpu_is_the_plain_version():
    prev, curr, frustum, k2s, intr, post_rots, post_trans = _case(24)
    uf, vf = build_cv_plan(*map(T, (frustum, k2s, intr, post_rots,
                                    post_trans)), 16, 24)
    p = T(prev).reshape(2, 16, 24, 8).to(torch.bfloat16)
    c = T(curr).reshape(2, 16, 24, 8).to(torch.bfloat16)
    before = kernel_launches()["stereo_cost_volume_cuda"]
    got = stereo_cost_volume_cuda(p, c, uf, vf, 5.0)
    assert kernel_launches()["stereo_cost_volume_cuda"] == before
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 24)
    # bf16 features are upcast before the warp
    torch.testing.assert_close(got, cv_cost_plain(p.float(), c.float(), uf,
                                                  vf, 5.0))
