"""The port's evaluation metrics (dhd_tpu_torch.eval) against the JAX
package's on the CPU: the confusion matrix and mIoU, FScore and the
legacy detection utilities exactly; the lidar fan; the DDA ray march on
tests/test_rayiou.py's cases exactly and on the full fan over a random
grid; scene origins and RayIoU from fixture infos."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu.eval import detection_legacy as j_det
from dhd_tpu.eval import fscore as j_fscore
from dhd_tpu.eval import miou as j_miou
from dhd_tpu.eval import rayiou as j_ray
from dhd_tpu_torch.eval import detection_legacy as t_det
from dhd_tpu_torch.eval import fscore as t_fscore
from dhd_tpu_torch.eval import miou as t_miou
from dhd_tpu_torch.eval import rayiou as t_ray

FREE = t_ray.FREE_ID


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: under the test lane's parallel
    workers, thousands of small ops (the DDA loops) otherwise stall on the
    other workers' OpenMP threads (~40x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(seed, shape=(24, 20, 16), n=2):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, 18, (n,) + shape).astype(np.uint8)
    gt = np.where(rng.random((n,) + shape) < 0.5, pred,
                  rng.integers(0, 18, (n,) + shape)).astype(np.uint8)
    mask = rng.integers(0, 2, (n,) + shape).astype(np.uint8)
    return pred, gt, mask


def test_confusion_matrix_and_miou_equal_jax():
    metric, jmetric = t_miou.MIoUMetric(), j_miou.MIoUMetric()
    for seed in range(3):
        pred, gt, mask = _grids(seed)
        if seed == 2:
            gt[0, 0, 0, :4] = 255               # outside the matrix: dropped
            mask[0, 0, 0, :4] = 1
        cm = t_miou.confusion_matrix(torch.from_numpy(pred), gt, mask)
        assert cm.dtype == torch.int64
        np.testing.assert_array_equal(
            cm.numpy(), np.asarray(j_miou.confusion_matrix(
                jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask), 18)))
        metric.add_batch(torch.from_numpy(pred), gt, mask)
        jmetric.add_batch(pred, gt, mask)
    np.testing.assert_array_equal(metric.cm, jmetric.cm)
    assert metric.compute() == jmetric.compute()
    assert metric.summary() == jmetric.summary()
    assert metric.count == 6


def test_fscore_equals_jax():
    rng = np.random.default_rng(4)
    metric, jmetric = t_fscore.FScoreMetric(), j_fscore.FScoreMetric()
    for _ in range(2):
        gt = np.where(rng.random((40, 40, 8)) < 0.1,
                      rng.integers(0, 17, (40, 40, 8)), FREE).astype(np.uint8)
        pred = np.where(rng.random((40, 40, 8)) < 0.1,
                        rng.integers(0, 17, (40, 40, 8)), gt).astype(np.uint8)
        mask = rng.integers(0, 2, (40, 40, 8)).astype(np.uint8)
        metric.add_batch(pred, gt, mask, mask)
        jmetric.add_batch(pred, gt, mask, mask)
    assert metric.compute() == jmetric.compute()
    np.testing.assert_array_equal(t_fscore.voxel2points(gt),
                                  j_fscore.voxel2points(gt))


def test_detection_legacy_equals_jax():
    rng = np.random.default_rng(5)
    boxes = np.concatenate([rng.uniform(-5, 5, (12, 2)),
                            rng.uniform(1, 3, (12, 2)),
                            rng.uniform(-np.pi, np.pi, (12, 1))], 1)
    scores = rng.random(12)
    np.testing.assert_array_equal(
        t_det.nms_bev(boxes, scores, 0.2, post_max_size=6),
        j_det.nms_bev(boxes, scores, 0.2, post_max_size=6))
    np.testing.assert_array_equal(t_det.rotated_iou_bev(boxes[0], boxes),
                                  j_det.rotated_iou_bev(boxes[0], boxes))
    h = w = 8
    heads = [rng.random((2, 3, h, w)), rng.normal(0, 1, (2, 1, h, w)),
             rng.normal(0, 1, (2, 1, h, w)), rng.normal(0, 1, (2, 1, h, w)),
             rng.normal(0, 0.3, (2, 3, h, w)), rng.normal(0, 1, (2, 2, h, w)),
             rng.random((2, 2, h, w))]
    kw = dict(pc_range=[-40, -40, -5, 40, 40, 3], out_size_factor=8,
              voxel_size=[0.1, 0.1], max_num=10, score_threshold=0.3,
              post_center_range=[-45, -45, -5, 45, 45, 5])
    got = t_det.CenterPointBBoxCoder(**kw).decode(*heads)
    want = j_det.CenterPointBBoxCoder(**kw).decode(*heads)
    for g, w_ in zip(got, want):
        for k in ("bboxes", "scores", "labels"):
            np.testing.assert_array_equal(g[k], w_[k])


def test_lidar_rays_equal_jax():
    rays = t_ray.generate_lidar_rays()
    assert rays.shape == (14040, 3)
    np.testing.assert_array_equal(rays, j_ray.generate_lidar_rays())


def _march_both(occ, origin, endpts, steps=64):
    jd, jc = j_ray.ray_march(jnp.asarray(occ), jnp.asarray(origin),
                             jnp.asarray(endpts), steps)
    td, tc = t_ray.ray_march(torch.from_numpy(occ), torch.from_numpy(origin),
                             torch.from_numpy(endpts), steps)
    assert tc.dtype == torch.int32
    return np.asarray(jd), np.asarray(jc), td.numpy(), tc.numpy()


def test_ray_march_cases_equal_jax():
    """tests/test_rayiou.py's axis-aligned hit, miss and diagonal cases,
    and a ray that never enters the grid."""
    occ = np.zeros((20, 20, 8), np.float32)
    occ[15, 10, 4] = 1.0
    o = np.array([2.5, 10.5, 4.5], np.float32)
    end = np.array([[19.5, 10.5, 4.5]], np.float32)
    for grid in (occ, np.zeros_like(occ)):
        jd, jc, td, tc = _march_both(grid, o, end)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tc, jc)
    jd, jc, td, tc = _march_both(occ, np.array([-5.5, -3.0, 2.0], np.float32),
                                 np.array([[-9.0, -8.0, 2.0]], np.float32))
    assert td[0] == jd[0] == 0 and (tc == 0).all() and (jc == 0).all()

    rng = np.random.default_rng(0)
    occ = (rng.random((16, 16, 8)) < 0.05).astype(np.float32)
    origin = np.array([8.3, 7.7, 3.2], np.float32)
    dirs = rng.normal(0, 1, (32, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    jd, jc, td, tc = _march_both(occ, origin, origin + dirs * 5.0)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tc, jc)


def test_ray_march_full_fan_on_a_random_grid():
    """The 14,040-ray fan over a random 64x64x16 grid: at least 99.99% of
    rays hit the same voxel as JAX's, their distances within 1e-5 (on the
    CPU every ray is bit-equal)."""
    rng = np.random.default_rng(1)
    occ = (rng.random((64, 64, 16)) < 0.02).astype(np.float32)
    origin = np.array([31.7, 30.2, 4.5], np.float32)
    endpts = (t_ray.generate_lidar_rays() * 10 + origin).astype(np.float32)
    jd, jc, td, tc = _march_both(occ, origin, endpts, 448)
    same = (tc == jc).all(axis=1)
    assert same.mean() >= 0.9999
    np.testing.assert_allclose(td[same], jd[same], rtol=0, atol=1e-5)
    assert (td > 0).all()


def test_batched_march_equals_per_origin_marches():
    """One march of several origins through two grids equals the
    per-origin, per-grid marches of 448 steps bit for bit."""
    rng = np.random.default_rng(2)
    grids = (rng.random((2, 32, 32, 8)) < 0.03)
    rays = t_ray.generate_lidar_rays()[::7]
    origins = np.array([[16.2, 15.9, 3.5], [3.1, 28.4, 2.2],
                        [30.5, 1.5, 6.9]], np.float32)
    m = rays.shape[0]
    o_all = np.repeat(np.tile(origins, (2, 1)), m, axis=0)
    e_all = o_all + np.tile(rays, (6, 1)) * 20
    base = np.repeat(np.arange(2) * grids[0].size, 3 * m)
    occ = torch.from_numpy(grids.reshape(-1))
    d, c = t_ray.march(occ, grids.shape[1:], torch.from_numpy(o_all),
                       torch.from_numpy(e_all), torch.from_numpy(base))
    for g in range(2):
        for k in range(3):
            sl = slice((g * 3 + k) * m, (g * 3 + k + 1) * m)
            jd, jc = j_ray.ray_march(jnp.asarray(grids[g], jnp.float32),
                                     jnp.asarray(origins[k]),
                                     jnp.asarray(e_all[sl]))
            np.testing.assert_array_equal(d[sl].numpy(), np.asarray(jd))
            np.testing.assert_array_equal(c[sl].numpy(), np.asarray(jc))


def test_init_voxelize_equals_jax():
    rng = np.random.default_rng(3)
    points = rng.uniform(-1, 6, (2, 30, 3)).astype(np.float32)
    tindex = rng.integers(-1, 2, (2, 30)).astype(np.float32)
    for shape in ((2, 2, 4, 5, 5), (2, 1, 4, 5, 5)):
        np.testing.assert_array_equal(
            t_ray.init_voxelize(torch.from_numpy(points),
                                torch.from_numpy(tindex), shape).numpy(),
            np.asarray(j_ray.init_voxelize(jnp.asarray(points),
                                           jnp.asarray(tindex), shape)))


def _scene_infos(n=14):
    """Two scenes; the ego drives along a curve (rotations too)."""
    infos = []
    for i in range(n):
        yaw = 0.05 * i
        infos.append({
            "token": f"t{i}", "scene_token": f"s{i // 10}",
            "ego2global_rotation": [np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)],
            "ego2global_translation": [600.0 + 4.5 * i, 1200.0 + i, 0.0],
            "lidar2ego_rotation": [1.0, 0, 0, 0],
            "lidar2ego_translation": [0.9, 0.0, 1.8],
        })
    return infos


def test_scene_origins_and_rayiou_equal_jax():
    infos = _scene_infos()
    for i in (0, 5, 9, 12):
        np.testing.assert_array_equal(t_ray.scene_origins(infos, i),
                                      j_ray.scene_origins(infos, i))
    rng = np.random.default_rng(6)
    pc, vs = (-12.8, -12.8, -1.0, 12.8, 12.8, 5.4), 0.4
    preds, gts, origins = [], [], []
    for i in (3, 12):
        gt = np.full((64, 64, 16), FREE, np.uint8)
        gt[:, :, :2] = 11
        gt[rng.random((64, 64, 16)) < 0.02] = rng.integers(0, 17)
        pred = np.where(rng.random(gt.shape) < 0.9, gt,
                        rng.integers(0, 18, gt.shape)).astype(np.uint8)
        preds.append(pred)
        gts.append(gt)
        origins.append(t_ray.scene_origins(infos, i, max_origins=3))
    np.testing.assert_array_equal(
        t_ray.process_one_sample(gts[0], j_ray.generate_lidar_rays(),
                                 origins[0], pc, vs, device="cpu"),
        j_ray.process_one_sample(gts[0], j_ray.generate_lidar_rays(),
                                 origins[0], pc, vs))
    got = t_ray.rayiou_from_outputs(preds, gts, origins, pc, vs,
                                    device="cpu")
    want = j_ray.rayiou_from_outputs(preds, gts, origins, pc, vs)
    assert 0 < got["RayIoU"] < 1
    for k in ("RayIoU", "RayIoU@1", "RayIoU@2", "RayIoU@4"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(
        np.array(list(got["per_class"].values())),
        np.array(list(want["per_class"].values())))
    # calc_rayiou alone, on the same ray outputs
    pcd = [j_ray.process_one_sample(g, j_ray.generate_lidar_rays(), o, pc,
                                    vs) for g, o in zip(gts, origins)]
    assert (t_ray.calc_rayiou(pcd[::-1], pcd)["RayIoU"]
            == j_ray.calc_rayiou(pcd[::-1], pcd)["RayIoU"])


def test_rayiou_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ray.rayiou_from_outputs([], [], [])
