"""The port's segment-sum (dhd_tpu_torch.ops.segment_sum) and legacy
pooling API (bev_pool, bev_pool_v2) against the JAX package's, on the CPU,
where the kernel wrapper takes its plain version.  The JAX segment-sum runs
its Pallas kernel in interpret mode, as tests/test_pallas_pool.py does.
Kernel B2 itself is held to the plain version on the card in
tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu.ops.pallas_pool import segment_sum_pooling as j_pooling
from dhd_tpu.ops.pallas_pool import sorted_segment_sum_pallas as j_sorted
from dhd_tpu.ops.voxel_pool import bev_pool as j_bev_pool
from dhd_tpu.ops.voxel_pool import bev_pool_v2 as j_bev_pool_v2
from dhd_tpu_torch.ops import (bev_pool, bev_pool_v2, segment_sum_pooling,
                               sorted_segment_sum, sorted_segment_sum_plain)
from dhd_tpu_torch.profiling import kernel_launches

T = torch.from_numpy
BF16_ULP = 2.0 ** -7


def _case(layout, c, seed=0, p=3000, v=1000):
    """Values and ids of one layout: JAX's ``_case`` (a hot segment with
    10% of the points, and ids equal to V), all points in one id, many
    empty blocks, or negative ids besides."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 1, (p, c)).astype(np.float32)
    seg = rng.integers(0, v, p)
    if layout == "hot":
        seg[: p // 10] = v // 2
        seg[-5:] = v
    elif layout == "one_id":
        seg[:] = v // 2 + 13
    elif layout == "sparse":
        # a few occupied runs with thousands of empty segments between
        seg = rng.choice([3, 4, 700, 2500, 2501, 9999], p)
        v = 10000
    elif layout == "negative":
        seg = rng.integers(-v // 4, v + v // 4, p)
    return vals, seg.astype(np.int32), v


def _within(got, want, terms, ulps=0.0):
    """|got - want| within 1e-5 of the summed |terms| behind each output,
    plus ``ulps`` bf16 ulps of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-5 * np.asarray(terms) + ulps * BF16_ULP * np.abs(want) + 1e-30
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


CASES = [(layout, 64) for layout in ("hot", "one_id", "sparse", "negative")
         ] + [("hot", c) for c in (8, 16, 96, 160)]


@pytest.mark.parametrize("layout,c", CASES)
def test_sorted_segment_sum_matches_pallas(layout, c):
    """fp32 in and out, and bf16 in with fp32 out, against the Pallas
    kernel on the same sorted rows, within 1e-5 of the summed |terms|;
    C = 8/16 ride the TPU kernel's two-pillar lane packing, 96/160 its lane
    padding.  Empty segments are exact zeros."""
    vals, seg, v = _case(layout, c)
    order = np.argsort(seg, kind="stable")
    vals_s, seg_s = vals[order], seg[order]
    terms = sorted_segment_sum_plain(T(np.abs(vals_s)), T(seg_s), v).numpy()
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        x = T(vals_s).to(dt)
        want = j_sorted(jnp.asarray(x.float().numpy(), jdt),
                        jnp.asarray(seg_s), v, interpret=True)
        before = kernel_launches()["sorted_segment_sum"]
        got = sorted_segment_sum(x, T(seg_s), v)
        assert kernel_launches()["sorted_segment_sum"] == before
        assert got.dtype == torch.float32 and got.shape == (v, c)
        _within(got.numpy(), want, terms)
        in_range = seg[(seg >= 0) & (seg < v)]
        empty = np.bincount(in_range, minlength=v) == 0
        assert (got.numpy()[empty] == 0).all()


@pytest.mark.parametrize("layout,c", CASES)
def test_segment_sum_pooling_matches_pallas(layout, c):
    """The unsorted entry: fp32 within 1e-5 of the summed |terms|, bf16
    out within one bf16 ulp of JAX's (plus the same fp32 share); the
    ``order`` form of the sorted entry gives the same sums."""
    vals, seg, v = _case(layout, c, seed=1)
    terms = sorted_segment_sum_plain(T(np.abs(vals)), T(seg), v).numpy()
    want = j_pooling(jnp.asarray(vals), jnp.asarray(seg), v, True)
    got = segment_sum_pooling(T(vals), T(seg), v)
    assert got.dtype == torch.float32
    _within(got.numpy(), want, terms)
    seg_s, order = torch.sort(T(seg), stable=True)
    via_order = sorted_segment_sum(T(vals), seg_s, v,
                                   order=order.to(torch.int32))
    torch.testing.assert_close(via_order, got, rtol=0, atol=0)

    xb = T(vals).to(torch.bfloat16)
    want = j_pooling(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                     jnp.asarray(seg), v, True)
    got = segment_sum_pooling(xb, T(seg), v)
    assert got.dtype == torch.bfloat16
    _within(got.float().numpy(), np.asarray(want, np.float32), terms,
            ulps=1.0)


@pytest.mark.parametrize("layout", ["hot", "negative"])
def test_segment_sum_pooling_gradient_matches_jax(layout):
    """d/dvals of sum(out**2), autograd against jax.grad through JAX's
    custom_vjp (tests/test_pallas_pool.py:38-50): a gather of 2*out, zero
    for dropped ids."""
    vals, seg, v = _case(layout, 16, seed=2, p=800, v=300)
    want = jax.grad(lambda x: jnp.sum(j_pooling(x, jnp.asarray(seg), v,
                                                True) ** 2))(
        jnp.asarray(vals))
    x = T(vals).requires_grad_(True)
    (segment_sum_pooling(x, T(seg), v) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    dropped = (seg < 0) | (seg >= v)
    assert dropped.any() and (x.grad.numpy()[dropped] == 0).all()


def test_segment_sum_pooling_takes_int64_ids():
    vals, seg, v = _case("negative", 8, seed=3)
    big = seg.astype(np.int64)
    big[:7] = 2 ** 40                                 # beyond int32: dropped
    got = segment_sum_pooling(T(vals), T(big), v)
    want = sorted_segment_sum_plain(T(vals), T(big), v)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


def test_bev_pool_v2_reference_fixture():
    """The reference's inline self-test (ops/bev_pool_v2/bev_pool.py:163-
    194, tests/test_voxel_pool.py:14-37): output sum 4.4 and the
    hand-computed gradients wrt depth and feat, as JAX gets them."""
    depth = torch.tensor([0.3, 0.4, 0.2, 0.1, 0.7, 0.6, 0.8, 0.9]
                         ).reshape(1, 1, 2, 2, 2).requires_grad_(True)
    feat = torch.ones((1, 1, 2, 2, 2), requires_grad=True)
    ranks = [torch.tensor(r, dtype=torch.int32) for r in
             ([0, 4, 1, 6], [0, 0, 1, 2], [0, 0, 1, 1])]
    out = bev_pool_v2(depth, feat, *ranks, (1, 1, 2, 2, 2))
    assert out.shape == (1, 1, 2, 2, 2)
    loss = out.sum()
    loss.backward()
    assert abs(float(loss.detach()) - 4.4) < 1e-6
    np.testing.assert_allclose(depth.grad.numpy().ravel(),
                               [2., 2., 0., 0., 2., 0., 2., 0.], atol=1e-6)
    np.testing.assert_allclose(feat.grad.numpy().ravel(),
                               [1.0, 1.0, 0.4, 0.4, 0.8, 0.8, 0., 0.],
                               atol=1e-6)


def test_bev_pool_v2_random_matches_jax():
    """Unsorted ranks, some beyond the grid: the pooled grid and the
    gradients of sum(out**2) wrt depth and feat within 1e-5."""
    rng = np.random.default_rng(4)
    shape = (2, 2, 3, 4, 5)                            # B, Dz, Dy, Dx, C
    depth = rng.random((2, 3, 4, 2, 3)).astype(np.float32)
    feat = rng.normal(0, 1, (2, 3, 2, 3, 5)).astype(np.float32)
    p = 400
    ranks = (rng.integers(0, depth.size, p), rng.integers(0, 2 * 3 * 2 * 3, p),
             rng.integers(0, 2 * 2 * 3 * 4 + 6, p))
    ranks = [r.astype(np.int32) for r in ranks]

    def j_loss(d, f):
        out = j_bev_pool_v2(d, f, *map(jnp.asarray, ranks), shape)
        return jnp.sum(out ** 2), out

    (_, want), grads = jax.value_and_grad(j_loss, argnums=(0, 1),
                                          has_aux=True)(
        jnp.asarray(depth), jnp.asarray(feat))
    d, f = T(depth).requires_grad_(True), T(feat).requires_grad_(True)
    out = bev_pool_v2(d, f, *map(T, ranks), shape)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for got, w in ((d.grad, grads[0]), (f.grad, grads[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("pool", ["sum", "max"])
def test_bev_pool_v1_matches_jax(pool):
    """The cases of tests/test_tools.py:11-30 (duplicate points summed or
    maxed, empty pillars 0, out-of-grid points dropped) and a random one
    with negative features, (B, C, Dz, Dy, Dx) out."""
    feats = np.asarray([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], np.float32)
    coords = np.asarray([[1, 0, 0, 0], [1, 0, 0, 0], [0, 1, 0, 0]], np.int32)
    got = bev_pool(T(feats), T(coords), 1, 1, 2, 2, pool)
    assert got.shape == (1, 2, 1, 2, 2)
    want = np.asarray(j_bev_pool(jnp.asarray(feats), jnp.asarray(coords),
                                 b=1, dz=1, dy=2, dx=2, pool=pool))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[0, :, 0, 1, 1] == 0).all()
    np.testing.assert_array_equal(
        got.numpy()[0, :, 0, 0, 1], [4.0, 6.0] if pool == "sum" else
        [3.0, 4.0])
    out = bev_pool(torch.ones((2, 3)), torch.tensor([[5, 0, 0, 0],
                                                     [-1, 0, 0, 0]]),
                   1, 1, 2, 2, pool)
    assert float(out.abs().sum()) == 0.0

    rng = np.random.default_rng(5)
    feats = rng.normal(0, 1, (300, 3)).astype(np.float32)
    coords = np.stack([rng.integers(-1, 5, 300), rng.integers(0, 4, 300),
                       rng.integers(0, 3, 300), rng.integers(0, 2, 300)],
                      axis=-1).astype(np.int32)
    want = np.asarray(j_bev_pool(jnp.asarray(feats), jnp.asarray(coords),
                                 b=2, dz=2, dy=3, dx=4, pool=pool))
    got = bev_pool(T(feats), T(coords), 2, 2, 3, 4, pool)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("dtype,c,offset,want", [
    (torch.bfloat16, 8, 0, 1), (torch.bfloat16, 64, 0, 2),
    (torch.bfloat16, 96, 0, 4), (torch.bfloat16, 256, 0, 4),
    (torch.bfloat16, 256, 1, 1), (torch.bfloat16, 256, 2, 2),
    (torch.float32, 64, 0, 2), (torch.float32, 256, 0, 4),
    (torch.float32, 33, 0, 1), (torch.bfloat16, 7, 0, 1)])
def test_channels_per_lane(dtype, c, offset, want):
    """B2's channels per lane: the fewest passes of 32 lanes over C, at
    most 4 channels a lane (wider accesses measured slower on an H100),
    no more than the rows' alignment allows."""
    from dhd_tpu_torch.ops.segment_sum import channels_per_lane

    rows = torch.zeros(4 * c + 4, dtype=dtype)[offset:offset + 4 * c]
    assert channels_per_lane(rows.view(4, c)) == want

