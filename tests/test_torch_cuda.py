"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test here needs a CUDA device and skips without one.
No JAX here: on the GPU machine run
``python -m pytest --noconftest tests/test_torch_cuda.py -q``."""
import numpy as np
import pytest
import torch

from dhd_tpu_torch.config import GridConfig, ViewTransformConfig
from dhd_tpu_torch.geometry import create_frustum
from dhd_tpu_torch.nn.swin import _shift_attn_mask
from dhd_tpu_torch.ops import (build_cv_plan, build_pool_plan,
                               compute_pool_indices, cv_cost_plain,
                               fused_layer_norm_cuda, layer_norm_plain,
                               mghs_pool_cuda, mghs_pool_plan_plain,
                               segment_sum_pooling, sorted_segment_sum,
                               sorted_segment_sum_plain,
                               stereo_cost_volume_cuda, window_attention_cuda,
                               window_attention_plain)

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


def test_mghs_pool_bf16_gradients_on_the_card(cuda):
    """B1 under autograd in bf16, as bf16 mixed-precision training runs
    it: the depth and feat gradients of its autograd Function are the fp32
    ones on the same values rounded to bf16 (the torch-ops backward sums
    in fp32), within one bf16 ulp plus 2^-20 of the tensor's peak for the
    summation order."""
    args, plan = _pool_inputs(cuda, torch.bfloat16)
    weights = [None, None]
    grads = {}
    before = mghs_pool_cuda.launches
    for dt in (torch.bfloat16, torch.float32):
        depth, feat = (a.to(dt, copy=True).requires_grad_(True)
                       for a in args[:2])
        out = mghs_pool_cuda(depth, feat, args[2].to(dt), plan)
        assert all(o.dtype == dt and o.grad_fn is not None for o in out)
        for i, o in enumerate(out):
            if weights[i] is None:
                weights[i] = torch.randn(
                    o.shape, generator=torch.Generator().manual_seed(i)
                ).to(cuda, torch.bfloat16)
        sum((o * w.to(dt)).sum() for o, w in zip(out, weights)).backward()
        grads[dt] = (depth.grad, feat.grad)
    assert mghs_pool_cuda.launches == before + 2
    for g16, g32 in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert g16.dtype == torch.bfloat16 and g32.dtype == torch.float32
        tol = 2 ** -7 * g32.abs() + 2 ** -20 * float(g32.abs().max())
        assert bool(((g16.float() - g32).abs() <= tol).all())
        assert float(g32.abs().max()) > 0


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


POOL_LAYOUTS = ("uniform", "uniform_piece8", "hot", "one_row", "none",
                "z_out", "gates_off")


def _pool_case(dev, dtype, layout, c=8, seed=11, fit_scratch=False,
               indices=False):
    """4,096 points (1 sample, 8 cameras of 4x16 pixels, 8 depth bins) on
    the tiny grid, with a BEV z range taller than the fine grid so that some
    points reach bev only:

    - ``uniform``: random points, some outside the grid, random gates;
      ``uniform_piece8`` the same with a schedule of 8-point pieces (many
      pillars split);
    - ``hot``: every point in one pillar, at random heights;
    - ``one_row``: every point in one pillar and one fine z row;
    - ``none``: no point in the grid;
    - ``z_out``: every point above the fine grid (z_s = -1);
    - ``gates_off``: random points, every gate off.

    ``fit_scratch`` builds the plan with its scratch slots counted;
    ``indices`` returns the layout's (vt, PoolIndices, cams_shape)
    instead of the plan and inputs.
    """
    import dataclasses

    from dhd_tpu_torch.ops.mghs_pool_cuda import pool_schedule_plain

    vt = ViewTransformConfig(input_size=(64, 256), downsample=16,
                             depth=GridConfig(1.0, 9.0, 1.0),
                             x=GridConfig(-4.0, 4.0, 0.4),
                             y=GridConfig(-4.0, 4.0, 0.4),
                             z_full=GridConfig(-3.0, 7.0, 10.0),
                             out_channels=c)
    rng = np.random.default_rng(seed)
    b, n, (fh, fw) = 1, 8, vt.feat_size
    coords = rng.uniform(-5.0, 5.0, (b, n, vt.D, fh, fw, 3))
    coords[..., 2] = rng.uniform(-3.0, 7.0, coords[..., 2].shape)
    if layout in ("hot", "one_row"):
        coords[..., :2] = (0.1, -0.3)
    if layout == "one_row":
        coords[..., 2] = 1.1
    if layout == "none":
        coords[..., 0] = 100.0
    if layout == "z_out":
        coords[..., 2] = 6.0
    idx = compute_pool_indices(
        torch.tensor(coords, dtype=torch.float32, device=dev), vt)
    if indices:
        return vt, idx, (b, n, vt.D, fh, fw)
    plan = build_pool_plan(idx, vt, (b, n, vt.D, fh, fw),
                           fit_scratch=fit_scratch)
    if layout == "uniform_piece8":
        tasks, splits, n_slots = pool_schedule_plain(
            plan.starts, plan.dix_s.numel(), piece=8)
        plan = dataclasses.replace(plan, tasks=tasks, splits=splits,
                                   n_slots=n_slots)
    band = rng.integers(0, 4, (b, n, fh, fw))
    gates = np.stack([band == k for k in range(3)], axis=-1)
    if layout == "gates_off":
        gates[:] = False
    depth = torch.softmax(torch.tensor(
        rng.normal(0, 2, (b, n, fh, fw, vt.D)), device=dev), -1)
    args = [depth, rng.normal(0, 1, (b, n, fh, fw, c)), gates]
    return [torch.as_tensor(a, device=dev).to(dtype) for a in args], plan


def _assert_pool_close(got, want, terms, dtype):
    """fp32 within 1e-5, bf16 within one bf16 ulp (2^-7 relative), each
    plus 2^-20 of the summed |terms| (a few thousand fp32 terms a pillar
    sum in another order here)."""
    for g, w, a in zip(got, want, terms):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        g, w = g.float(), w.float()
        tol = (1e-5 if dtype == torch.float32 else 2 ** -7 * w.abs()) \
            + 2 ** -20 * a.float()
        assert bool(((g - w).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", POOL_LAYOUTS)
def test_mghs_pool_kernel_layouts(cuda, dtype, layout):
    """Each layout against the plain version; the empty ones exactly 0."""
    args, plan = _pool_case(cuda, dtype, layout)
    before = mghs_pool_cuda.launches
    got = mghs_pool_cuda(*args, plan)
    assert mghs_pool_cuda.launches == before + 1
    want = mghs_pool_plan_plain(*args, plan)
    terms = mghs_pool_plan_plain(args[0], args[1].abs(), args[2], plan)
    torch.cuda.synchronize()
    _assert_pool_close(got, want, terms, dtype)
    bev, vox = got
    per_pillar = plan.starts[1:] - plan.starts[:-1]
    if layout == "none":
        assert int(plan.starts[-1]) == 0
        assert not bev.any() and not vox.any()
    elif layout in ("z_out", "gates_off"):
        assert not vox.any() and bev.any()
    else:
        assert vox.any()
    if layout in ("hot", "one_row"):
        assert int(per_pillar.max()) == plan.dix_s.numel() == 4096
        assert int((vox.float().abs().sum(-1) > 0).sum()) \
            == (1 if layout == "one_row" else 16)
    if layout == "uniform_piece8":
        assert int((per_pillar > 8).sum()) > 10


@pytest.mark.parametrize("c", [1, 6, 8, 9, 17, 18, 24, 34, 64, 72, 128,
                               136, 256, 520])
def test_mghs_pool_kernel_widths(cuda, c):
    """Every width the wrapper takes: 1, 2 or 4 channels a lane, 8, 16 or
    32 lanes a point, in one or more passes over the channels; split (hot)
    and whole (uniform) pillars."""
    for layout, dtype in (("hot", torch.float32), ("uniform_piece8",
                                                   torch.float32),
                          ("uniform", torch.bfloat16)):
        args, plan = _pool_case(cuda, dtype, layout, c=c)
        got = mghs_pool_cuda(*args, plan)
        want = mghs_pool_plan_plain(*args, plan)
        terms = mghs_pool_plan_plain(args[0], args[1].abs(), args[2], plan)
        torch.cuda.synchronize()
        _assert_pool_close(got, want, terms, dtype)


def test_mghs_pool_kernel_rejects_no_channels(cuda):
    (depth, feat, band_mask), plan = _pool_case(cuda, torch.float32,
                                                "uniform")
    before = mghs_pool_cuda.launches
    with pytest.raises(ValueError, match="C=0"):
        mghs_pool_cuda(depth, feat[..., :0].contiguous(), band_mask, plan)
    with pytest.raises(ValueError, match="tasks"):
        import dataclasses
        mghs_pool_cuda(depth, feat, band_mask, dataclasses.replace(
            plan, tasks=plan.tasks[:, :3].contiguous()))
    assert mghs_pool_cuda.launches == before


@pytest.mark.parametrize("piece", [1, 8, 128, 256])
@pytest.mark.parametrize("layout", ["uniform", "hot", "one_row", "none"])
def test_pool_plan_kernel_matches_plain(cuda, layout, piece):
    """The plan kernels give the plain version's tables and lists exactly
    (the same order, slots and padding) and count one launch; the plan's
    fitted slot count is the slots its split pillars use."""
    from dhd_tpu_torch.ops.mghs_pool_cuda import (pool_plan_cuda,
                                                  pool_plan_plain)
    vt, idx, shape = _pool_case(cuda, torch.float32, layout, indices=True)
    key_s, order = torch.sort(idx.key, stable=True)
    args = (key_s, order, idx.seg_vox, idx.num_seg_vox, shape,
            vt.z_fine.size, piece)
    before = pool_plan_cuda.launches
    got = pool_plan_cuda(*args)
    assert pool_plan_cuda.launches == before + 1
    want = pool_plan_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w)
    assert got[5] == want[5]
    if piece == 128:
        _, plan = _pool_case(cuda, torch.float32, layout)
        _, fitted = _pool_case(cuda, torch.float32, layout, fit_scratch=True)
        assert fitted.n_slots == int((plan.tasks[:, 3] >= 0).sum())
        assert fitted.n_slots <= plan.n_slots
        assert torch.equal(fitted.tasks, plan.tasks)


def test_pool_plan_kernel_rejects_bad_inputs(cuda):
    from dhd_tpu_torch.ops.mghs_pool_cuda import pool_plan_cuda
    vt, idx, shape = _pool_case(cuda, torch.float32, "uniform", indices=True)
    key_s, order = torch.sort(idx.key, stable=True)
    args = [key_s, order, idx.seg_vox, idx.num_seg_vox, shape,
            vt.z_fine.size]
    before = pool_plan_cuda.launches
    for piece in (0, 257):
        with pytest.raises(ValueError, match="piece"):
            pool_plan_cuda(*args, piece)
    with pytest.raises(ValueError, match="order"):
        pool_plan_cuda(key_s, order.int(), *args[2:])
    with pytest.raises(ValueError, match="key_s"):
        pool_plan_cuda(key_s.long(), *args[1:])
    assert pool_plan_cuda.launches == before


def test_mghs_pool_kernel_needs_a_schedule(cuda):
    """A plan without the kernel's schedule (as a CPU plan is) is refused
    on the card, not pooled plainly."""
    import dataclasses
    args, plan = _pool_case(cuda, torch.float32, "uniform")
    before = mghs_pool_cuda.launches
    with pytest.raises(ValueError, match="schedule"):
        mghs_pool_cuda(*args, dataclasses.replace(plan, tasks=None))
    assert mghs_pool_cuda.launches == before


@pytest.mark.parametrize("layout", ["hot", "uniform_piece8"])
def test_mghs_pool_kernel_bit_identical(cuda, layout):
    """Two calls give the same bits: split pillars are added in slot
    order, with no atomics; so does a plan whose scratch is fitted to the
    slots it uses."""
    args, plan = _pool_case(cuda, torch.bfloat16, layout, c=64)
    _, fitted = _pool_case(cuda, torch.bfloat16, layout, c=64,
                           fit_scratch=True)
    first = mghs_pool_cuda(*args, plan)
    second = mghs_pool_cuda(*args, plan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    if layout == "hot":
        assert 0 < fitted.n_slots < plan.n_slots
        third = mghs_pool_cuda(*args, fitted)
        assert all(torch.equal(a, b) for a, b in zip(first, third))


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


def _bf16_ulps(a, b):
    """Element-wise distance in bf16 ulps between two bf16 tensors."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _check_layer_norm(cuda, dtype, rows, c, seed):
    """B5 against its plain version on (rows, c): fp32 within 1e-5; bf16
    within one bf16 ulp of each element plus 2^-20 (8 fp32 ulps) of the
    terms it is computed from.  Only the order of the fp32 row sums
    differs, but where (x - mu) * mul cancels against the bias the result
    is tiny, and an fp32-level difference is many of its bf16 ulps."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (3 * torch.randn(rows + (c,), generator=g, device=cuda) + 0.5
         ).to(dtype)
    w = 1 + 0.2 * torch.randn(c, generator=g, device=cuda)
    b = 0.5 * torch.randn(c, generator=g, device=cuda)
    before = fused_layer_norm_cuda.launches
    got = fused_layer_norm_cuda(x, w, b)
    assert fused_layer_norm_cuda.launches == before + 1
    want = layer_norm_plain(x, w, b)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0)
        mul = (torch.rsqrt(var + 1e-6) * w).abs()
        wf = want.float()
        ulp = torch.where(wf == 0, 0.0,
                          torch.exp2(torch.floor(torch.log2(wf.abs())) - 7))
        tol = ulp + 2.0 ** -20 * ((xf.abs() + mu.abs()) * mul + b.abs())
        assert bool(((got.float() - wf).abs() <= tol).all())
        assert float((_bf16_ulps(got, want) <= 1).float().mean()) > 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [8, 136, 512, 2048])
def test_layer_norm_kernel_matches_plain(cuda, dtype, c):
    """B5 against its plain version on (3, 77, c); see _check_layer_norm."""
    _check_layer_norm(cuda, dtype, (3, 77), c, seed=c)


@pytest.mark.parametrize("rows,c", [
    ((1001,), 128),          # two rows per warp, an odd row count
    ((3,), 128),             # fewer rows than one block's first step
    ((1, 5), 256),           # a warp per row, fewer rows than warps
    ((4225,), 1024),         # 4 warps per row, rows not a multiple of 2
    ((4231,), 2048),         # 8 warps per row, not a multiple of the grid
    ((3, 700), 512)])        # 2 warps per row, 2,100 rows
def test_layer_norm_kernel_edges(cuda, rows, c):
    """B5 in bf16 where the persistent walk has a ragged end: rows that do
    not fill the last step, a grid larger than the rows, and every width
    of the row's lane group (16 lanes to 8 warps)."""
    _check_layer_norm(cuda, torch.bfloat16, rows, c, seed=sum(rows) + c)


def test_layer_norm_kernel_rejects_bad_inputs(cuda):
    x = torch.randn((4, 64), device=cuda)
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    before = fused_layer_norm_cuda.launches
    with pytest.raises(ValueError, match="C=12"):
        fused_layer_norm_cuda(x[:, :12].contiguous(), w[:12], b[:12])
    with pytest.raises(ValueError, match="C=4096"):
        fused_layer_norm_cuda(x.repeat(1, 64), w.repeat(64), b.repeat(64))
    with pytest.raises(ValueError, match="contiguous"):
        fused_layer_norm_cuda(x.t().contiguous().t(), w, b)
    with pytest.raises(ValueError, match="weight"):
        fused_layer_norm_cuda(x, w.bfloat16(), b)
    with pytest.raises(TypeError):
        fused_layer_norm_cuda(x.half(), w, b)
    assert fused_layer_norm_cuda.launches == before


def _attn_inputs(dev, dtype, ws, heads, hd, shifted, n_img_w=2, seed=7):
    """Unit-normal qkv and bias (tools/check_attn_parity.py) for images of
    2 x n_img_w windows, with the real shift mask or none."""
    n, c = ws * ws, heads * hd
    hp, wp = 2 * ws, n_img_w * ws
    n_img = 2 * n_img_w
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((3 * n_img, n, 3 * c), generator=g, device=dev)
    bias = torch.randn((heads, n, n), generator=g, device=dev)
    mask = (torch.from_numpy(_shift_attn_mask(hp, wp, ws, ws // 2)).to(dev)
            if shifted else None)
    return (qkv.to(dtype), bias.to(dtype),
            None if mask is None else mask.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ws,heads,hd,shifted", [
    (4, 2, 16, True), (7, 3, 32, False), (12, 4, 32, True),
    (12, 2, 16, False), (16, 2, 32, True)])
def test_window_attention_kernel_matches_plain(cuda, dtype, ws, heads, hd,
                                               shifted):
    """B4 against its plain version (the XLA composition): fp32 within
    1e-5; bf16 within 4 bf16 ulps of the output's peak, the bar the TPU
    kernel held against XLA (tools/check_attn_parity.py).  Window 16
    (N = 256) takes more than 48 KB of shared memory."""
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv, bias, mask = _attn_inputs(cuda, dtype, ws, heads, hd, shifted)
    before = window_attention_cuda.launches
    got = window_attention_cuda(qkv, bias, mask, heads)
    assert window_attention_cuda.launches == before + 1
    want = window_attention_plain(qkv, bias, mask, heads)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        _check_attention_bf16(got, want)


def _check_attention_bf16(got, want):
    """bf16 within 4 bf16 ulps of the output's peak."""
    peak = want.float().abs().max()
    ulp = 2.0 ** (torch.floor(torch.log2(peak)) - 7)
    assert float((got.float() - want.float()).abs().max()) <= 4 * ulp


def test_window_attention_kernel_odd_pairs(cuda):
    """A block per (head, window) pair, head-major: an odd number of
    windows (3 images of 1 x 5 windows, each with its own shift mask) and
    of heads (5), so that a head's pairs and a mask's windows straddle
    every boundary of the grid."""
    heads, hd, ws = 5, 16, 4
    g = torch.Generator(device=cuda).manual_seed(11)
    n, c = ws * ws, heads * hd
    qkv = torch.randn((15, n, 3 * c), generator=g, device=cuda)
    bias = torch.randn((heads, n, n), generator=g, device=cuda)
    mask = torch.from_numpy(_shift_attn_mask(ws, 5 * ws, ws, ws // 2))
    assert mask.shape[0] == 5
    args = [t.to(cuda, torch.bfloat16) for t in (qkv, bias, mask)]
    got = window_attention_cuda(*args, heads)
    want = window_attention_plain(*args, heads)
    torch.cuda.synchronize()
    _check_attention_bf16(got, want)


@pytest.mark.parametrize("shifted", [True, False])
def test_window_attention_kernel_stage3_heads(cuda, shifted):
    """Swin-B stage 3's layout: 32 heads of 32 (C = 1024), window 12."""
    qkv, bias, mask = _attn_inputs(cuda, torch.bfloat16, 12, 32, 32, shifted)
    got = window_attention_cuda(qkv, bias, mask, 32)
    want = window_attention_plain(qkv, bias, mask, 32)
    torch.cuda.synchronize()
    _check_attention_bf16(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_kernel_zero_mask_is_no_mask(cuda, dtype):
    """A (1, N, N) zero mask adds exact zeros: the same output as
    ``mask=None``, bit for bit."""
    qkv, bias, _ = _attn_inputs(cuda, dtype, 12, 4, 32, False)
    zero = torch.zeros((1,) + bias.shape[1:], dtype=dtype, device=cuda)
    before = window_attention_cuda.launches
    got = window_attention_cuda(qkv, bias, zero, 4)
    assert window_attention_cuda.launches == before + 1
    assert torch.equal(got, window_attention_cuda(qkv, bias, None, 4))


def test_window_attention_kernel_rejects_bad_inputs(cuda):
    qkv, bias, mask = _attn_inputs(cuda, torch.float32, 4, 2, 16, True)
    before = window_attention_cuda.launches
    with pytest.raises(ValueError, match="unsupported shape"):
        window_attention_cuda(qkv, bias, mask, 4)            # hd = 8
    big = torch.zeros((2, 289, 96), device=cuda)             # window 17
    with pytest.raises(ValueError, match="unsupported shape"):
        window_attention_cuda(big, torch.zeros((2, 289, 289), device=cuda),
                              None, 2)
    with pytest.raises(ValueError, match="multiple"):
        window_attention_cuda(qkv[:6].contiguous(), bias, mask, 2)
    with pytest.raises(ValueError, match="bias"):
        window_attention_cuda(qkv, bias.bfloat16(), mask, 2)
    with pytest.raises(ValueError, match="qkv"):
        window_attention_cuda(qkv.transpose(0, 1), bias, mask, 2)
    with pytest.raises(TypeError):
        window_attention_cuda(qkv.half(), bias.half(), mask.half(), 2)
    assert window_attention_cuda.launches == before


def _segsum_inputs(dev, dtype, c, layout="uniform", p=20000, v=9000, seed=8):
    """Unsorted values and ids: uniform over 1.5 V, with 10% of the points
    on one id, or with negative ids."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, int(1.5 * v), p)
    if layout == "hot":
        seg[: p // 10] = v // 3
    elif layout == "negative":
        seg = rng.integers(-v // 2, v + v // 2, p)
    vals = torch.tensor(rng.normal(0, 1, (p, c)), dtype=dtype, device=dev)
    return vals, torch.tensor(seg, dtype=torch.int32, device=dev), v


@pytest.mark.parametrize("dtype,out_dtype,c,layout", [
    (torch.bfloat16, torch.bfloat16, 64, "uniform"),
    (torch.bfloat16, torch.float32, 64, "hot"),
    (torch.float32, torch.float32, 64, "negative"),
    (torch.float32, torch.bfloat16, 8, "uniform"),
    (torch.bfloat16, torch.bfloat16, 96, "hot"),
    (torch.bfloat16, torch.bfloat16, 160, "negative"),
    (torch.float32, torch.float32, 256, "uniform"),
    (torch.bfloat16, torch.bfloat16, 7, "hot")])
def test_segment_sum_kernel_matches_plain(cuda, dtype, out_dtype, c, layout):
    """B2 against its plain version on the same sorted rows: fp32 out
    within 2^-20 of the summed |terms|, bf16 out within one bf16 ulp of
    the result plus that; empty segments exactly 0; the unsorted entry
    (the kernel gathering the rows itself) gives the same sums bit for
    bit."""
    vals, seg, v = _segsum_inputs(cuda, dtype, c, layout)
    seg_s, order = torch.sort(seg, stable=True)
    vals_s = vals[order].contiguous()
    before = sorted_segment_sum.launches
    got = sorted_segment_sum(vals_s, seg_s, v, out_dtype)
    assert sorted_segment_sum.launches == before + 1
    want = sorted_segment_sum_plain(vals_s, seg_s, v, out_dtype)
    terms = sorted_segment_sum_plain(vals_s.abs(), seg_s, v)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (v, c)
    wf = want.float()
    ulp = (torch.where(wf == 0, 0.0,
                       torch.exp2(torch.floor(torch.log2(wf.abs())) - 7))
           if out_dtype == torch.bfloat16 else 0.0)
    assert bool(((got.float() - wf).abs() <= ulp + 2.0 ** -20 * terms).all())
    keep = seg[(seg >= 0) & (seg < v)].long()
    empty = torch.bincount(keep, minlength=v) == 0
    assert bool(empty.any()) and bool((got[empty] == 0).all())
    if out_dtype == dtype:
        unsorted = segment_sum_pooling(vals, seg, v)
        assert sorted_segment_sum.launches == before + 2
        assert torch.equal(unsorted, got)


def test_segment_sum_kernel_gradient(cuda):
    """The unsorted entry's backward on the card: a gather of the output
    gradient, zero for dropped ids."""
    vals, seg, v = _segsum_inputs(cuda, torch.float32, 16, "negative")
    x = vals.clone().requires_grad_(True)
    out = segment_sum_pooling(x, seg, v)
    (out ** 2).sum().backward()
    keep = (seg >= 0) & (seg < v)
    want = torch.where(keep[:, None], 2 * out.detach()[
        seg.clamp(0, v - 1).long()], 0.0)
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)


def test_segment_sum_kernel_rejects_bad_inputs(cuda):
    vals, seg, v = _segsum_inputs(cuda, torch.float32, 8)
    seg_s, _ = torch.sort(seg)
    before = sorted_segment_sum.launches
    with pytest.raises(ValueError, match="seg_sorted"):
        sorted_segment_sum(vals, seg_s.long(), v)
    with pytest.raises(ValueError, match="vals"):
        sorted_segment_sum(vals.t(), seg_s, v)
    with pytest.raises(ValueError, match="rows"):
        sorted_segment_sum(vals[:-1].contiguous(), seg_s, v)
    with pytest.raises(ValueError, match="order"):
        sorted_segment_sum(vals, seg_s, v, order=seg_s[:-1])
    with pytest.raises(ValueError, match="too large"):
        sorted_segment_sum(vals, seg_s, 2 ** 28)
    with pytest.raises(TypeError):
        sorted_segment_sum(vals.half(), seg_s, v)
    with pytest.raises(TypeError):
        sorted_segment_sum(vals, seg_s, v, torch.float16)
    assert sorted_segment_sum.launches == before


def test_time_ms_counts_device_time_only(cuda):
    """chip_smoke.time_ms reads the device's time of a call, not the
    host's: a call that spends 0.3 ms on the host before one tiny launch
    reads far below 0.3 ms (events around it on an idle card would wait
    for the host, as they did before the sleep kernel ahead of them)."""
    import time

    import chip_smoke

    x = torch.ones(1024, device=cuda)

    def call():                 # a busy wait: sleep() may take far longer
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 3e-4:
            pass
        x.add_(1.0)

    assert chip_smoke.time_ms(call, iters=10, warmup=2) < 0.1


def test_time_ms_idle_counts_host_time(cuda):
    """With ``busy=False`` chip_smoke.time_ms reads the call on an idle
    device, the host's work before the launch included, and host_us the
    host's time of the call alone."""
    import time

    import chip_smoke

    x = torch.ones(1024, device=cuda)

    def call():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 3e-4:
            pass
        x.add_(1.0)

    assert chip_smoke.time_ms(call, iters=10, warmup=2, busy=False) > 0.25
    assert chip_smoke.host_us(call, iters=10, warmup=2) > 250


SEGSUM_EDGES = {
    # name: (P, V, C, ids): P ids from a seeded rng, before sorting
    "one_id_many_shares": (50000, 1000, 64, lambda r, p, v: np.full(p, 417)),
    "v1": (5000, 1, 64, lambda r, p, v: r.integers(-1, 3, p)),
    "p0": (0, 300, 64, lambda r, p, v: np.zeros(0, np.int64)),
    "hot_first": (30000, 2000, 96, lambda r, p, v: np.where(
        r.random(p) < 0.3, 0, r.integers(0, v, p))),
    "hot_last": (30000, 2000, 96, lambda r, p, v: np.where(
        r.random(p) < 0.3, v - 1, r.integers(0, v, p))),
    "negative": (20000, 3000, 64, lambda r, p, v: r.integers(-v, v, p)),
    "odd_c7": (20000, 900, 7, lambda r, p, v: np.where(
        r.random(p) < 0.5, 5, r.integers(-3, v + 3, p))),
    "odd_c33": (20000, 900, 33, lambda r, p, v: r.integers(0, 2 * v, p)),
}


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("case", sorted(SEGSUM_EDGES))
def test_segment_sum_kernel_edges(cuda, case, dtype, out_dtype):
    """B2 where the merge-path split matters: one segment over hundreds of
    warps' shares, every point on one id, V = 1, no points, a hot id at the
    first and at the last segment, negative ids, odd C.  Against the plain
    version as in test_segment_sum_kernel_matches_plain; the kernel
    gathering the rows itself (``order``) gives the same sums bit for bit,
    and so does a second launch."""
    p, v, c, ids = SEGSUM_EDGES[case]
    rng = np.random.default_rng(len(case))
    seg = torch.tensor(ids(rng, p, v), dtype=torch.int32, device=cuda)
    vals = torch.tensor(rng.normal(0, 1, (p, c)), dtype=dtype, device=cuda)
    seg_s, order = torch.sort(seg, stable=True)
    vals_s = vals[order].contiguous()
    before = sorted_segment_sum.launches
    got = sorted_segment_sum(vals_s, seg_s, v, out_dtype)
    gathered = sorted_segment_sum(vals, seg_s, v, out_dtype,
                                  order=order.to(torch.int32))
    again = sorted_segment_sum(vals_s, seg_s, v, out_dtype)
    assert sorted_segment_sum.launches == before + 3
    want = sorted_segment_sum_plain(vals_s, seg_s, v, out_dtype)
    terms = sorted_segment_sum_plain(vals_s.abs(), seg_s, v)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (v, c)
    assert torch.equal(got, gathered) and torch.equal(got, again)
    wf = want.float()
    ulp = (torch.where(wf == 0, 0.0,
                       torch.exp2(torch.floor(torch.log2(wf.abs())) - 7))
           if out_dtype == torch.bfloat16 else 0.0)
    assert bool(((got.float() - wf).abs() <= ulp + 2.0 ** -20 * terms).all())
    keep = seg[(seg >= 0) & (seg < v)].long()
    empty = torch.bincount(keep, minlength=v) == 0
    assert bool((got[empty] == 0).all())
    if out_dtype == dtype:
        assert torch.equal(segment_sum_pooling(vals, seg, v), got)


def _cv_edge_inputs(dev, dtype, c, hs, ws, depth):
    """_cv_inputs on a map whose width is no multiple of the kernel's
    pixel tiles, with two depth bins all sentinel and exact zeros in
    channel 0 over a band of the previous frame."""
    from dhd_tpu_torch.ops.cost_volume import SENTINEL

    rng = np.random.default_rng(c + hs)
    bn = 2
    intr = np.zeros((1, bn, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = ws * 4 * 0.8
    intr[..., 0, 2], intr[..., 1, 2], intr[..., 2, 2] = ws * 2, hs * 2, 1.0
    k2s = np.broadcast_to(np.eye(4, dtype=np.float32), (1, bn, 4, 4)).copy()
    k2s[0, :, :3, 3] = rng.uniform(-0.3, 0.3, (bn, 3))
    frustum = create_frustum(depth, (hs * 4, ws * 4), 4, device=dev)
    t = lambda a: torch.tensor(a, device=dev)
    uf, vf = build_cv_plan(frustum, t(k2s), t(intr),
                           torch.eye(3, device=dev).expand(1, bn, 3, 3),
                           torch.zeros(1, bn, 3, device=dev), hs, ws)
    uf[:, 1], vf[:, 1] = SENTINEL, SENTINEL
    uf[:, -1], vf[:, -1] = SENTINEL, SENTINEL
    prev, curr = (torch.tensor(rng.normal(0, 1, (bn, hs, ws, c)),
                               dtype=dtype, device=dev) for _ in range(2))
    prev[:, hs // 3: hs // 2, :, 0] = 0
    return prev, curr, uf.contiguous(), vf.contiguous()


@pytest.mark.parametrize("dtype,c", [
    (torch.bfloat16, 8), (torch.bfloat16, 64), (torch.bfloat16, 128),
    (torch.bfloat16, 256), (torch.bfloat16, 512), (torch.float32, 8),
    (torch.float32, 128), (torch.float32, 256)])
def test_cost_volume_kernel_widths(cuda, dtype, c):
    """B3 at every lane-group width (one lane to 32 lanes a pixel, and two
    chunks a lane), on a 13 x 37 map (no multiple of any pixel tile) with
    13 depth bins (no multiple of the bins staged at a time), two bins all
    sentinel and channel-0 zeros in the signed previous features: the
    costs within rtol 1e-5 of plain, the bias on the same samples, the
    sentinel bins at sum |curr| + bias."""
    prev, curr, uf, vf = _cv_edge_inputs(cuda, dtype, c, 13, 37,
                                         GridConfig(1.0, 7.5, 0.5))
    assert uf.shape[1] == 13
    before = stereo_cost_volume_cuda.launches
    got = stereo_cost_volume_cuda(prev, curr, uf, vf, 5.0)
    assert stereo_cost_volume_cuda.launches == before + 1
    want = cv_cost_plain(prev, curr, uf, vf, 5.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * c ** 0.5)
    no_bias = cv_cost_plain(prev, curr, uf, vf, 0.0)
    hit = (want - no_bias) > 2.5
    assert bool(((got - no_bias > 2.5) == hit).all())
    assert bool(hit[:, 1].all()) and bool((hit & (uf > -1e3)).any())
    off = curr.float().abs().sum(-1) + 5.0
    torch.testing.assert_close(got[:, 1], off, rtol=1e-5,
                               atol=1e-4 * c ** 0.5)
    torch.testing.assert_close(torch.softmax(-got, 1),
                               torch.softmax(-want, 1), atol=2e-5, rtol=1e-4)


def _grads(mod, loss_fn):
    mod.zero_grad()
    loss_fn().backward()
    return {n: p.grad.detach().cpu() for n, p in mod.named_parameters()
            if p.grad is not None}


def test_swin_gradients_on_the_card(cuda):
    """A small Swin (embed 32, heads of 16, window 4) in fp32 under
    training on the card against the same weights on the CPU: every
    parameter's gradient within 2e-4 of its peak (B4 and B5 step aside
    under autograd).  Under no_grad the same module launches them."""
    from dhd_tpu_torch.nn.swin import SwinTransformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = SwinTransformer(32, (2, 2), (2, 4), 4, (1,), drop_path_rate=0.0)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    gpu = SwinTransformer(32, (2, 2), (2, 4), 4, (1,),
                          drop_path_rate=0.0).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 3, 32, 48, generator=torch.Generator().manual_seed(2))
    r = [torch.randn(o.shape, generator=torch.Generator().manual_seed(3))
         for o in cpu(x)]
    attn, ln = window_attention_cuda.launches, fused_layer_norm_cuda.launches
    g_gpu = _grads(gpu, lambda: sum((o * w.to(cuda)).sum()
                                    for o, w in zip(gpu(x.to(cuda)), r)))
    assert (window_attention_cuda.launches, fused_layer_norm_cuda.launches
            ) == (attn, ln)
    g_cpu = _grads(cpu, lambda: sum((o * w).sum() for o, w in zip(cpu(x), r)))
    assert set(g_gpu) == set(g_cpu) == {n for n, _ in cpu.named_parameters()}
    for n, g in g_cpu.items():
        peak = max(1e-3, float(g.abs().max()))
        assert float((g_gpu[n] - g).abs().max()) / peak < 2e-4, n
    with torch.no_grad():
        gpu(x.to(cuda))
    assert window_attention_cuda.launches == attn + 4
    assert fused_layer_norm_cuda.launches == ln + 11


def test_view_transformer_gradients_on_the_card(cuda):
    """dhd_tiny's view transformer in fp32 under training with the cached
    plan: B1 forward on the card and its torch backward, against the same
    weights on the CPU (the plain plan forward), the image features' and
    every parameter's gradient within 2e-4 of its peak."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.models import DHDNet, build_batch_pool_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("dhd_tiny")
    batch = synthetic_batch(cfg, batch_size=1, seed=6, with_gt=False)
    fh, fw = cfg.vt.feat_size
    x0 = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, (1, cfg.num_cams, cfg.vt.in_channels, fh, fw)).astype(
            np.float32))
    gpu = DHDNet(cfg, device=cuda, generator=torch.Generator().manual_seed(5))
    cpu = DHDNet(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    grads = []
    for model, dev in ((gpu, cuda), (cpu, torch.device("cpu"))):
        plan = build_batch_pool_plan(cfg, batch, device=dev)
        x = x0.to(dev).requires_grad_(True)
        vt_mod = model.img_view_transformer
        before = mghs_pool_cuda.launches
        out = vt_mod(x, model._geom(batch), plan)
        assert mghs_pool_cuda.launches == before + (dev.type == "cuda")
        g = _grads(vt_mod, lambda: out["bev"].square().sum()
                   + out["vox"].square().sum())
        g["x"] = x.grad.cpu()
        grads.append(g)
    g_gpu, g_cpu = grads
    assert set(g_gpu) == set(g_cpu) and len(g_cpu) > 2
    for n, g in g_cpu.items():
        peak = max(1e-3, float(g.abs().max()))
        assert float((g_gpu[n] - g).abs().max()) / peak < 2e-4, n


def test_confusion_matrix_on_the_card_equals_the_cpu(cuda):
    from dhd_tpu_torch.eval import confusion_matrix
    rng = np.random.default_rng(11)
    pred, gt = rng.integers(0, 18, (2, 2, 40, 40, 16), dtype=np.uint8)
    mask = rng.integers(0, 2, (2, 40, 40, 16), dtype=np.uint8)
    got = confusion_matrix(torch.from_numpy(pred).to(cuda), gt, mask)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), confusion_matrix(torch.from_numpy(pred),
                                                   gt, mask))


def test_ray_march_and_render_on_the_card_follow_the_cpu(cuda):
    """The DDA first hit of the lidar fan: at most 0.01% of rays at another
    voxel (a direction one ulp off can flip the strict `<`); the density
    render within 1e-4 of the CPU's peak (the card's gradient sums by
    atomics)."""
    from dhd_tpu_torch.eval.rayiou import generate_lidar_rays, ray_march
    from dhd_tpu_torch.ops.dvr import render
    rng = np.random.default_rng(12)
    occ = torch.from_numpy((rng.random((64, 64, 16)) < 0.02)
                           .astype(np.float32))
    origin = torch.tensor([31.7, 30.2, 4.5])
    ends = torch.from_numpy(generate_lidar_rays() * 10) + origin
    d_c, c_c = ray_march(occ.to(cuda), origin, ends)
    d, c = ray_march(occ, origin, ends)
    moved = ~(c_c.cpu() == c).all(dim=1)
    assert moved.float().mean() <= 1e-4
    assert (d_c.cpu() - d)[~moved].abs().max() <= 1e-3
    sigma = torch.where(occ.permute(2, 1, 0) > 0, 2.0, 0.02)[None, None]
    case = (sigma, origin[None, None], ends[None], torch.zeros(1, len(ends)))
    want = render(*case)
    got = render(*(t.to(cuda) for t in case))
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert (g.cpu() - w).abs().max() <= 1e-4 * w.abs().max()


def test_eval_cli_on_the_card_launches_b1(cuda, capsys):
    from dhd_tpu_torch.cli.test import main
    from dhd_tpu_torch.ops.mghs_pool_cuda import pool_plan_cuda
    before = (mghs_pool_cuda.launches, pool_plan_cuda.launches)
    assert main(["--preset", "dhd_tiny", "--synthetic"]) == 0
    assert "evaluated 2 samples" in capsys.readouterr().out
    assert (mghs_pool_cuda.launches, pool_plan_cuda.launches) == (
        before[0] + 2, before[1] + 2)
