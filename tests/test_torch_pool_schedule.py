"""The pooling kernel's schedule (``PoolPlan.tasks``, ``.splits``,
``.n_slots``; ``dhd_tpu_torch.ops.mghs_pool_cuda.pool_schedule_plain``) on
the CPU: every in-grid point lies in exactly one task, in order; the split
pillars' pieces own distinct scratch slots; it is built from torch ops
alone (it builds on the ``meta`` device, where any host read raises); a
plan built on the CPU carries no schedule, and the plan kernels' wrapper
takes its plain version there; and a torch emulation of the kernel's two
passes over the schedule equals the plain pooling, which does not read it
at all.  Also the kernel's lanes a point for each width.  The plan kernels
are held against their plain version in tests/test_torch_cuda.py."""
import dataclasses

import numpy as np
import pytest
import torch

from dhd_tpu_torch.config import GridConfig, ViewTransformConfig
from dhd_tpu_torch.ops import (build_pool_plan, compute_pool_indices,
                               mghs_pool_plan_plain)
from dhd_tpu_torch.ops.mghs_pool_cuda import (POOL_PIECE, lanes_per_point,
                                              pool_plan_cuda,
                                              pool_plan_plain,
                                              pool_schedule_plain)
from dhd_tpu_torch.profiling import kernel_launches

VT = ViewTransformConfig(input_size=(64, 256), downsample=16,
                         depth=GridConfig(1.0, 9.0, 1.0),
                         x=GridConfig(-4.0, 4.0, 0.4),
                         y=GridConfig(-4.0, 4.0, 0.4),
                         z_full=GridConfig(-3.0, 7.0, 10.0), out_channels=8)
SHAPE = (1, 8, VT.D) + VT.feat_size           # 4,096 points


def _coords(layout, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-5.0, 5.0, SHAPE + (3,))
    coords[..., 2] = rng.uniform(-3.0, 7.0, SHAPE)
    if layout in ("hot", "one_row"):
        coords[..., :2] = (0.1, -0.3)
    if layout == "one_row":
        coords[..., 2] = 1.1
    if layout == "none":
        coords[..., 0] = 100.0
    return torch.tensor(coords, dtype=torch.float32)


def _plan(layout, piece):
    plan = build_pool_plan(compute_pool_indices(_coords(layout), VT), VT,
                           SHAPE)
    tasks, splits, n_slots = pool_schedule_plain(plan.starts,
                                                 plan.dix_s.numel(), piece)
    return dataclasses.replace(plan, tasks=tasks, splits=splits,
                               n_slots=n_slots)


def _in_order(plan):
    """The real tasks' columns (pillar, first point, end point, slot) in
    pillar and point order, and the number of real tasks."""
    n_pillars, p = plan.starts.numel() - 1, plan.dix_s.numel()
    pillar, p0, p1, slot = plan.tasks.long().unbind(-1)
    n_real = int((pillar < n_pillars).sum())
    order = torch.argsort(pillar[:n_real] * (p + 1) + p0[:n_real])
    return tuple(x[:n_real][order] for x in (pillar, p0, p1, slot)), n_real


CASES = [(layout, piece) for layout in ("uniform", "hot", "one_row", "none")
         for piece in (4, 32, POOL_PIECE)]


@pytest.mark.parametrize("layout,piece", CASES)
def test_every_point_in_one_task_in_order(layout, piece):
    plan = _plan(layout, piece)
    starts = plan.starts.long()
    n_pillars, p = starts.numel() - 1, plan.dix_s.numel()
    assert plan.tasks.dtype == torch.int32
    assert plan.tasks.shape == (n_pillars + p // piece, 4)
    (pillar, p0, p1, slot), n_real = _in_order(plan)
    # the real tasks first, the most points first, ties in pillar order
    tasks = plan.tasks.long()
    real = tasks[:, 0] < n_pillars
    assert bool(real[:n_real].all()) and not bool(real[n_real:].any())
    size = tasks[:n_real, 2] - tasks[:n_real, 1]
    assert bool((size[1:] <= size[:-1]).all())
    empty = tasks[:n_real][size == 0, 0]
    assert bool((empty[1:] > empty[:-1]).all())
    # in pillar and point order: each pillar at least once, the point
    # ranges tiling [0, P_in) inside their pillars, at most `piece` each
    assert torch.equal(torch.unique_consecutive(pillar),
                       torch.arange(n_pillars))
    assert int(p0[0]) == 0 and int(p1[-1]) == int(starts[-1])
    assert torch.equal(p0[1:], p1[:-1])
    assert bool((p1 - p0 <= piece).all()) and bool((p1 >= p0).all())
    assert bool((p0 >= starts[pillar]).all())
    assert bool((p1 <= starts[pillar + 1]).all())
    # padding: empty ranges at the end of the points, no slot
    pad = tasks[n_real:]
    assert bool((pad[:, 1:3] == starts[-1]).all())
    assert bool((pad[:, 3] == -1).all())


@pytest.mark.parametrize("layout,piece", CASES)
def test_split_pillars_own_their_slots(layout, piece):
    plan = _plan(layout, piece)
    starts = plan.starts.long()
    n_pillars, p = starts.numel() - 1, plan.dix_s.numel()
    counts = starts[1:] - starts[:-1]
    (pillar, _, _, slot), _ = _in_order(plan)
    long_ = counts[pillar] > piece
    assert bool((slot[~long_] == -1).all())
    # distinct slots 0, 1, ... in pillar and point order, within n_slots
    used = slot[long_]
    assert torch.equal(used, torch.arange(used.numel()))
    assert used.numel() <= plan.n_slots == 2 * (p // piece)
    # splits: the long pillars in order, their first slot and piece count,
    # then padding
    want = torch.nonzero(counts > piece).flatten()
    assert plan.splits.shape == (min(n_pillars, p // (piece + 1)), 4)
    sp, first, pieces, zero = plan.splits.long().unbind(-1)
    k = want.numel()
    assert torch.equal(sp[:k], want)
    assert bool((sp[k:] == n_pillars).all()) and not bool(zero.any())
    assert torch.equal(pieces[:k], (counts[want] + piece - 1) // piece)
    for e in range(k):
        mine = slot[pillar == sp[e]]
        assert torch.equal(mine, torch.arange(int(first[e]),
                                              int(first[e] + pieces[e])))


def test_schedule_needs_no_host_sync():
    """The uncached serving path plans every frame: the plan and the plain
    schedule build from meta tensors, which hold no data to read back (the
    kernel is one launch sized by the same shapes)."""
    coords = torch.empty(SHAPE + (3,), device="meta")
    plan = build_pool_plan(compute_pool_indices(coords, VT), VT, SHAPE)
    n_pillars, p = VT.x.size * VT.y.size, int(np.prod(SHAPE))
    tasks, splits, n_slots = pool_schedule_plain(plan.starts, p)
    assert tasks.device.type == "meta"
    assert tasks.shape == (n_pillars + p // POOL_PIECE, 4)
    assert splits.shape == (min(n_pillars, p // (POOL_PIECE + 1)), 4)
    assert n_slots == 2 * (p // POOL_PIECE)
    with pytest.raises(Exception):
        int(plan.starts[-1])                  # a host read does raise here


def test_cpu_plan_has_no_schedule():
    """Only a plan on the card carries the kernel's schedule: the plain
    pooling, which CPU tensors take, never reads it.  The plan kernels'
    wrapper takes its plain version on a CPU tensor (no launch counted):
    the CPU plan's tables and the plain schedule.  It refuses other
    devices."""
    idx = compute_pool_indices(_coords("hot"), VT)
    plan = build_pool_plan(idx, VT, SHAPE)
    assert plan.tasks is None and plan.splits is None and plan.n_slots == 0
    key_s, order = torch.sort(idx.key, stable=True)
    args = (key_s, order, idx.seg_vox, idx.num_seg_vox, SHAPE,
            VT.z_fine.size)
    before = kernel_launches()["pool_plan_cuda"]
    got = pool_plan_cuda(*args)
    assert kernel_launches()["pool_plan_cuda"] == before
    want = (plan.dix_s, plan.z_s, plan.starts) + pool_schedule_plain(
        plan.starts, plan.dix_s.numel())
    for g, w, p in zip(got, want, pool_plan_plain(*args)):
        if isinstance(w, int):
            assert g == w == p
        else:
            assert torch.equal(g, w) and torch.equal(p, w)
    with pytest.raises(ValueError, match="device"):
        pool_plan_cuda(*(a.to("meta") for a in args[:3]), *args[3:])


def _emulate_kernel(depth, feat, band_mask, plan):
    """The kernel's two passes in torch ops, over the plan's schedule: each
    task sums its points into its pillar's rows, or into its slot's partial
    block; the second pass adds each split pillar's blocks in slot order."""
    b, dy, dx, dz = plan.grid
    d, c = depth.shape[-1], feat.shape[-1]
    n_pillars = b * dy * dx
    dix = plan.dix_s.long()
    z = plan.z_s.long()
    pix = dix // d
    v = (depth.reshape(-1)[dix, None] * feat.reshape(-1, c)[pix]).float()
    e0, e1 = plan.band_edges
    band = (z >= e0).long() + (z >= e1).long()
    gate = (z >= 0) & (band_mask.reshape(-1, 3)[pix, band] > 0)
    row = torch.where(gate, z, dz)            # row dz: bev only
    vox = torch.full((n_pillars, dz + 1, c), float("nan"))
    bev = torch.full((n_pillars, c), float("nan"))
    part = torch.full((plan.n_slots, dz + 1, c), float("nan"))
    for pillar, p0, p1, slot in plan.tasks.tolist():
        if pillar >= n_pillars:
            continue
        rows = torch.zeros(dz + 1, c)
        rows.index_add_(0, row[p0:p1], v[p0:p1])
        rows[dz] = v[p0:p1].sum(0)
        if slot < 0:
            vox[pillar], bev[pillar] = rows, rows[dz]
        else:
            part[slot] = rows
    for pillar, first, pieces, _ in plan.splits.tolist():
        if pillar < n_pillars:
            rows = part[first:first + pieces].sum(0)
            vox[pillar], bev[pillar] = rows, rows[dz]
    return (bev.reshape(b, dy, dx, c),
            vox[:, :dz].reshape(b, dy, dx, dz, c))


@pytest.mark.parametrize("layout,piece", CASES)
def test_schedule_emulation_equals_plain(layout, piece):
    """Every output element written once (no NaN left) and the sums those
    of the plain version, which ignores the schedule: its result is the
    same bits under any piece size.  Sums of up to 4,096 fp32 terms in
    another order: atol and rtol 1e-5."""
    rng = np.random.default_rng(3)
    plan = _plan(layout, piece)
    px = SHAPE[:2] + SHAPE[3:]
    depth = torch.softmax(torch.tensor(rng.normal(0, 2, px + (VT.D,)),
                                       dtype=torch.float32), -1)
    feat = torch.tensor(rng.normal(0, 1, px + (8,)), dtype=torch.float32)
    band = rng.integers(0, 4, px)
    band_mask = torch.tensor(np.stack([band == k for k in range(3)], -1),
                             dtype=torch.float32)
    want = mghs_pool_plan_plain(depth, feat, band_mask, plan)
    for a, b in zip(want, mghs_pool_plan_plain(depth, feat, band_mask,
                                               _plan(layout, 7))):
        assert torch.equal(a, b)
    got = _emulate_kernel(depth, feat, band_mask, plan)
    for g, w in zip(got, want):
        assert not bool(torch.isnan(g).any())
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [1, 6, 8, 9, 17, 18, 24, 34, 64, 72, 128, 136,
                               256, 520])
def test_lanes_per_point(c):
    """The kernel's (channels a lane, lanes a point): the widest of 4, 2, 1
    channels that divides C, and the fewest of 8, 16, 32 lanes that hold
    the row (32 take a wider row in passes); an offset view that breaks
    the alignment gets fewer channels a lane."""
    feat = torch.zeros(3, c, dtype=torch.bfloat16)
    vec, lanes = lanes_per_point(feat)
    assert c % vec == 0 and all(c % w for w in (4, 2) if w > vec)
    assert lanes in (8, 16, 32)
    assert lanes * vec >= c or lanes == 32
    assert lanes == 8 or lanes * vec // 2 < c
    if vec > 1:
        shifted = torch.zeros(3 * c + 1, dtype=torch.bfloat16)[1:]
        assert lanes_per_point(shifted.view(3, c))[0] == 1
