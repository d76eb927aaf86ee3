"""The port's nuScenes data path (dhd_tpu_torch.data.nuscenes, .pipeline,
.loader and dhd_tpu_torch.native) against the JAX package's on the
on-disk fixture of tests/test_data_pipeline.py: the same batches bit for
bit, eval and train mode, single-frame and temporal; the native kernels
against JAX's and against their numpy versions."""
import pickle

import numpy as np
import pytest
import torch

import dhd_tpu.native as j_native
from dhd_tpu.config import get_config as j_config
from dhd_tpu.data import nuscenes as j_nus
from dhd_tpu.data.loader import PrefetchLoader as JLoader
from dhd_tpu.data.pipeline import SamplePipeline as JPipeline
from dhd_tpu.data.pipeline import collate as j_collate
from dhd_tpu_torch import native
from dhd_tpu_torch.config import get_config as t_config
from dhd_tpu_torch.data import nuscenes as t_nus
from dhd_tpu_torch.data.loader import PrefetchLoader
from dhd_tpu_torch.data.pipeline import IMG_MEAN, IMG_STD, SamplePipeline
from dhd_tpu_torch.data.pipeline import collate
from tests.test_data_pipeline import _write_fixture


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: under the test lane's parallel
    workers, thousands of small ops (the DDA loops) otherwise stall on the
    other workers' OpenMP threads (~40x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return _write_fixture(str(tmp_path_factory.mktemp("nus")))


def _equal_batches(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_quaternions_and_poses_match_jax():
    rng = np.random.default_rng(0)
    for q in rng.normal(0, 1, (8, 4)):
        np.testing.assert_array_equal(t_nus.quat_to_rot(q),
                                      j_nus.quat_to_rot(q))
        t = rng.normal(0, 100, 3)
        np.testing.assert_array_equal(t_nus.pose_to_mat(q, t),
                                      j_nus.pose_to_mat(q, t))
    assert t_nus.CAM_NAMES == j_nus.CAM_NAMES


@pytest.mark.parametrize("preset", ["dhd_tiny", "dhd_tiny_stereo"])
def test_dataset_matches_jax(fixture, preset):
    cfg = t_config(preset)
    kw = dict(num_adj_frames=cfg.num_adj_frames, stereo=cfg.stereo)
    ds, jds = (t_nus.NuScenesOccDataset(fixture, **kw),
               j_nus.NuScenesOccDataset(fixture, **kw))
    assert len(ds) == len(jds) == 4
    assert pickle.dumps(ds.data_infos) == pickle.dumps(jds.data_infos)
    for i in range(len(ds)):
        assert pickle.dumps(ds.get_sample(i)) == pickle.dumps(
            jds.get_sample(i))
    np.testing.assert_array_equal(
        t_nus.load_lidar_points(ds.data_infos[1]["lidar_path"]),
        j_nus.load_lidar_points(ds.data_infos[1]["lidar_path"]))


@pytest.mark.parametrize("preset,is_train", [
    ("dhd_tiny", False), ("dhd_tiny", True), ("dhd_tiny_stereo", False),
    ("dhd_tiny_stereo", True)])
def test_pipeline_batches_match_jax(fixture, preset, is_train):
    """Eval mode, and train mode from one seed (image and BEV
    augmentation, the lidar projection through the native kernel)."""
    cfg, jcfg = t_config(preset), j_config(preset)
    kw = dict(num_adj_frames=cfg.num_adj_frames, stereo=cfg.stereo)
    ds = t_nus.NuScenesOccDataset(fixture, **kw)
    jds = j_nus.NuScenesOccDataset(fixture, **kw)
    pipe = SamplePipeline(cfg, is_train=is_train, seed=0)
    jpipe = JPipeline(jcfg, is_train=is_train, seed=0)
    got = collate([pipe(ds.get_sample(i)) for i in (3, 0)])
    want = j_collate([jpipe(jds.get_sample(i)) for i in (3, 0)])
    _equal_batches(got, want)
    if is_train:
        assert (got["gt_depth"] > 0).any()
        assert "gt_depth" in got and "gt_height" in got
    else:
        assert "gt_depth" not in got


def test_loader_order_and_batches_match_jax(fixture):
    """The same seed and shard give the same shuffled order and batches,
    the tail kept or dropped as asked."""
    cfg, jcfg = t_config("dhd_tiny"), j_config("dhd_tiny")
    ds = t_nus.NuScenesOccDataset(fixture)
    jds = j_nus.NuScenesOccDataset(fixture)
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False),
               dict(shuffle=True, seed=3, drop_last=False, shard=(1, 2))):
        loader = PrefetchLoader(ds, SamplePipeline(cfg, False), 3,
                                num_workers=2, **kw)
        jloader = JLoader(jds, JPipeline(jcfg, False), 3, num_workers=2,
                          **kw)
        assert len(loader) == len(jloader)
        for _ in range(2):                   # two epochs: the rng moves on
            got, want = list(loader), list(jloader)
            assert len(got) == len(want) == len(loader)
            for a, b in zip(got, want):
                _equal_batches(a, b)


def test_native_builds_into_the_build_dir():
    assert native.get_lib() is not None
    assert native.lib_path().parent.name == "dhd_tpu_torch"
    assert native.lib_path().parent.parent.name == "build"
    assert native.lib_path().exists()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No quiet numpy fallback: a source that does not compile raises."""
    bad = tmp_path / "dhd_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()


def _projection_case():
    """tests/test_native.py's rig: 3 cameras around the ego, 2000 points."""
    rng = np.random.default_rng(1)
    n_pts, n_cams, h, w = 2000, 3, 64, 96
    points = rng.uniform(-30, 30, (n_pts, 3)).astype(np.float32)
    points[:, 2] = rng.uniform(-2, 4, n_pts)
    lidar2ego = np.eye(4, dtype=np.float32)
    lidar2ego[2, 3] = 1.8
    lidar2img = np.zeros((n_cams, 4, 4), np.float32)
    for c in range(n_cams):
        th = 2 * np.pi * c / n_cams
        f = np.array([np.cos(th), np.sin(th), 0.0])
        right = np.cross(f, [0, 0, 1.0])
        r = np.stack([right, np.cross(f, right), f], 0)
        k = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]])
        lidar2img[c] = np.eye(4, dtype=np.float32)
        lidar2img[c, :3, :3] = k @ r
    post_rot = np.tile(np.eye(3, dtype=np.float32), (n_cams, 1, 1))
    post_rot[:, 0, 0] = 0.9
    post_tran = np.zeros((n_cams, 3), np.float32)
    post_tran[:, 1] = 2.0
    return (points, lidar2img, lidar2ego, post_rot, post_tran, (h, w),
            (1.0, 45.0))


def test_native_kernels_match_jax_and_numpy():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 8, 12, 3), dtype=np.uint8)
    got = native.normalize_images(imgs, IMG_MEAN, IMG_STD)
    np.testing.assert_array_equal(
        got, j_native.normalize_images(imgs, IMG_MEAN, IMG_STD))
    np.testing.assert_allclose(
        got, native.normalize_images_numpy(imgs, IMG_MEAN, IMG_STD),
        rtol=1e-6, atol=1e-6)

    case = _projection_case()
    d, h = native.project_cameras(*case)
    jd, jh = j_native.project_cameras(*case)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(h, jh)
    nd, nh = native.project_cameras_numpy(*case)
    assert (nd > 0).sum() > 50
    # the same z-buffer but for ties between equal depths
    assert (np.abs(d - nd) > 1e-3).mean() < 0.002
    assert (np.abs(h - nh) > 1e-3).mean() < 0.002

    maps = np.where(rng.random((3, 16, 24)) < 0.3,
                    rng.uniform(0.5, 60, (3, 16, 24)), 0).astype(np.float32)
    maps[0, :4, :4] = 0                            # an empty window
    for ds in (1, 4, 8):
        np.testing.assert_array_equal(native.min_pool_nonzero(maps, ds),
                                      native.min_pool_nonzero_numpy(maps, ds))
    assert native.min_pool_nonzero(maps, 4)[0, 0, 0] == np.float32(1e5)
