"""The port's MGHS pooling (dhd_tpu_torch.ops) against the JAX package's.

Both sides get the same numpy coordinates, so segment ids compare exactly;
the pooled sums are fp32 and differ only in summation order (atol 1e-4, as
the JAX package's own pooling tests).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu.config import GridConfig as JGrid
from dhd_tpu.config import ViewTransformConfig as JVT
from dhd_tpu.ops import compute_pool_indices as j_indices
from dhd_tpu.ops import mghs_pool as j_pool
from dhd_tpu.ops import mghs_pool_pallas as j_pool_pallas
from dhd_tpu_torch.config import GridConfig as TGrid
from dhd_tpu_torch.config import ViewTransformConfig as TVT
from dhd_tpu_torch.ops import (build_pool_plan, compute_pool_indices,
                               mghs_pool, mghs_pool_cuda)
from dhd_tpu_torch.profiling import kernel_launches


def _vts(z_full=(-1.0, 5.4, 6.4)):
    """The tiny grid of tests/test_voxel_pool.py in both packages."""
    kw = dict(input_size=(32, 64), downsample=16, out_channels=8)
    grids = dict(depth=(1.0, 9.0, 1.0), x=(-4.0, 4.0, 0.4),
                 y=(-4.0, 4.0, 0.4), z_full=z_full)
    return (JVT(**kw, **{k: JGrid(*v) for k, v in grids.items()}),
            TVT(**kw, **{k: TGrid(*v) for k, v in grids.items()}))


def _inputs(vt, b=2, n=2, seed=0):
    rng = np.random.default_rng(seed)
    fh, fw = vt.feat_size
    depth = rng.random((b, n, vt.D, fh, fw)).astype(np.float32)
    feat = rng.normal(0, 1, (b, n, fh, fw, vt.out_channels)).astype(np.float32)
    coords = rng.uniform(-5.0, 5.0, (b, n, vt.D, fh, fw, 3)).astype(np.float32)
    coords[..., 2] = rng.uniform(-2.0, 6.0, coords[..., 2].shape)
    band_idx = rng.integers(0, 4, (b, n, fh, fw))   # 3 = no band (top bin)
    band_mask = np.stack([band_idx == k for k in range(3)],
                         axis=-1).astype(np.float32)
    return depth, feat, coords, band_mask


def _port_pool(impl, depth, feat, coords, band_mask, vt):
    """The port's plain pooling: over unsorted indices ("indices") or over
    the sorted plan, the CUDA kernel's plain version ("plan")."""
    idx = compute_pool_indices(torch.from_numpy(coords), vt)
    if impl == "indices":
        bev, vox = mghs_pool(torch.from_numpy(depth), torch.from_numpy(feat),
                             torch.from_numpy(band_mask), idx, vt)
    else:
        plan = build_pool_plan(idx, vt, depth.shape)
        depth_px = torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(depth, 2, -1)))
        bev, vox = mghs_pool_cuda(depth_px, torch.from_numpy(feat),
                                  torch.from_numpy(band_mask), plan)
    return bev.numpy(), vox.numpy()


def _jax_pool(impl, depth, feat, coords, band_mask, vt):
    idx = j_indices(jnp.asarray(coords), vt)
    if impl == "xla":
        out = j_pool(jnp.asarray(depth), jnp.asarray(feat),
                     jnp.asarray(band_mask), idx, vt)
    else:
        out = j_pool_pallas(jnp.asarray(np.moveaxis(depth, 2, -1)),
                            jnp.asarray(feat), jnp.asarray(band_mask), idx,
                            vt, interpret=True)
    return tuple(np.asarray(o) for o in out)


@pytest.fixture(scope="module")
def pooled():
    """Inputs and both JAX pooling results, computed once."""
    jvt, tvt = _vts()
    args = _inputs(tvt, seed=5)
    return jvt, tvt, args, {impl: _jax_pool(impl, *args, jvt)
                            for impl in ("xla", "pallas")}


def test_compute_pool_indices_equals_jax():
    jvt, tvt = _vts()
    coords = _inputs(tvt, seed=1)[2]
    ji = j_indices(jnp.asarray(coords), jvt)
    ti = compute_pool_indices(torch.from_numpy(coords), tvt)
    for name in ("seg_bev", "seg_vox", "key", "band"):
        np.testing.assert_array_equal(getattr(ti, name).numpy(),
                                      np.asarray(getattr(ji, name)), name)
    assert (ti.num_seg_bev, ti.num_seg_vox) == (ji.num_seg_bev,
                                                ji.num_seg_vox)


def test_truncation_toward_zero_keeps_points_just_below_lower():
    """(lower - interval, lower) truncates to index 0 and is kept, as
    torch ``.long()`` in the reference (lss_heightmap.py:331-348)."""
    _, vt = _vts()
    fh, fw = vt.feat_size
    coords = torch.zeros(1, 1, vt.D, fh, fw, 3)
    coords[..., 0] = vt.x.lower - 0.5 * vt.x.interval
    idx = compute_pool_indices(coords, vt)
    assert int((idx.seg_bev < idx.num_seg_bev).sum()) == vt.D * fh * fw


@pytest.mark.parametrize("port", ["indices", "plan"])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_plain_pool_matches_jax(pooled, port, jax_impl):
    jvt, tvt, args, ref = pooled
    bev, vox = _port_pool(port, *args, tvt)
    np.testing.assert_allclose(bev, ref[jax_impl][0], atol=1e-4)
    np.testing.assert_allclose(vox, ref[jax_impl][1], atol=1e-4)


@pytest.mark.parametrize("port", ["indices", "plan"])
def test_out_of_grid_points_dropped(port):
    _, vt = _vts()
    depth, feat, coords, band_mask = _inputs(vt, b=1, n=1, seed=2)
    coords[:] = 1e3
    bev, vox = _port_pool(port, depth, feat, coords,
                          np.ones_like(band_mask), vt)
    assert not bev.any() and not vox.any()


@pytest.mark.parametrize("port", ["indices", "plan"])
def test_gated_off_points_reach_bev_not_vox(port):
    """A closed band gate and a fine z outside the fine grid (with z still
    inside the BEV's taller z range) both keep the point in bev only — the
    gate_eff rule of dhd_tpu/ops/voxel_pool.py:176-177 — and the port
    agrees with the JAX package on such a grid."""
    jvt, vt = _vts(z_full=(-3.0, 7.0, 10.0))
    depth, feat, coords, _ = _inputs(vt, b=1, n=2, seed=3)
    # even depth bins above the fine grid, odd ones inside it
    coords[..., 2] = np.where(np.arange(vt.D)[:, None, None] % 2 == 0,
                              6.0, 1.0)
    band_mask = np.zeros(feat.shape[:-1] + (3,), np.float32)
    band_mask[:, 0] = 1.0                      # camera 0 gated on everywhere
    bev, vox = _port_pool(port, depth, feat, coords, band_mask, vt)
    ref_bev, ref_vox = _jax_pool("xla", depth, feat, coords, band_mask, jvt)
    np.testing.assert_allclose(bev, ref_bev, atol=1e-4)
    np.testing.assert_allclose(vox, ref_vox, atol=1e-4)
    # vox holds camera 0's in-grid points only; bev every in-xy point
    only0 = _port_pool(port, depth[:, :1], feat[:, :1], coords[:, :1],
                       band_mask[:, :1], vt)
    odd = np.arange(vt.D) % 2 == 1
    in_fine = _port_pool(port, depth[:, :1] * odd[:, None, None], feat[:, :1],
                         coords[:, :1], band_mask[:, :1], vt)
    np.testing.assert_allclose(vox, in_fine[1], atol=1e-5)
    assert (np.abs(bev).sum() > np.abs(only0[0]).sum()
            > np.abs(in_fine[0]).sum())


def test_wrapper_on_cpu_counts_no_launch():
    _, vt = _vts()
    depth, feat, coords, band_mask = _inputs(vt, seed=4)
    before = kernel_launches()["mghs_pool_cuda"]
    _port_pool("plan", depth, feat, coords, band_mask, vt)
    assert kernel_launches()["mghs_pool_cuda"] == before


def test_plan_plain_sums_exactly_with_a_float64_accumulator():
    """``mghs_pool_plan_plain(..., acc_dtype=float64)`` sums the same fp32
    products as the fp32 version, exactly: it equals the fp32 sums within
    their rounding and, rounded to fp32, the products summed in float64
    point by point."""
    from dhd_tpu_torch.ops import mghs_pool_plan_plain

    _, vt = _vts()
    depth, feat, coords, band_mask = _inputs(vt, seed=5)
    plan = build_pool_plan(compute_pool_indices(torch.from_numpy(coords), vt),
                           vt, depth.shape)
    args = (torch.from_numpy(np.ascontiguousarray(np.moveaxis(depth, 2, -1))),
            torch.from_numpy(feat), torch.from_numpy(band_mask), plan)
    f32 = mghs_pool_plan_plain(*args)
    f64 = mghs_pool_plan_plain(*args, acc_dtype=torch.float64)
    ones = mghs_pool_plan_plain(args[0], torch.ones_like(args[1]), *args[2:],
                                acc_dtype=torch.float64)
    for a, b, n in zip(f32, f64, ones):
        assert a.dtype == b.dtype == torch.float32
        assert float(b.abs().sum()) > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2e-6 * float(n.max()))
    # the fullest pillar by hand: its points' fp32 products, summed in
    # float64
    d, f = args[0].reshape(-1), args[1].reshape(-1, vt.out_channels)
    p = int((plan.starts[1:] - plan.starts[:-1]).argmax())
    dix = plan.dix_s[int(plan.starts[p]):int(plan.starts[p + 1])].long()
    want = (d[dix, None] * f[dix // vt.D]).double().sum(0).float()
    assert len(dix) > 1
    assert torch.equal(f64[0].reshape(-1, vt.out_channels)[p], want)
