"""ctypes bindings for the native C++ data-path kernels: the port's copy of
``dhd_tpu/native``.

``src/dhd_native.cpp`` is compiled at first use with g++ into
``build/dhd_tpu_torch/`` at the repo root (beside the CUDA libraries of
``ops/cuda_build.py``), named by the hash of its source, so an edited
source is rebuilt and a built one is reused.  A failed build raises: the
bindings never fall back quietly.  The numpy versions (``*_numpy``) are
the same semantics in plain numpy, kept for the tests.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "dhd_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dhd_tpu_torch"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()
    return BUILD_DIR / f"libdhd_native_{digest[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native data-path kernels "
                           "need a C++ compiler") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)                # atomic: concurrent builds agree


def get_lib() -> ctypes.CDLL:
    """The built library, building it on first use (raises if it cannot)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.dhd_normalize_images.argtypes = [
            u8p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p]
        lib.dhd_project_cameras.argtypes = [
            f32p, ctypes.c_long, f32p, f32p, f32p, f32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, f32p, f32p]
        lib.dhd_min_pool_nonzero.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        for fn in (lib.dhd_normalize_images, lib.dhd_project_cameras,
                   lib.dhd_min_pool_nonzero):
            fn.restype = None
        _lib = lib
        return _lib


def normalize_images(imgs_u8: np.ndarray, mean: np.ndarray,
                     std: np.ndarray) -> np.ndarray:
    """(N, H, W, 3) uint8 RGB -> normalized float32 with the BGR-swap quirk."""
    imgs_u8 = np.ascontiguousarray(imgs_u8, np.uint8)
    if imgs_u8.ndim != 4 or imgs_u8.shape[-1] != 3:
        raise ValueError(f"want (N, H, W, 3) images, got {imgs_u8.shape}")
    n, h, w, _ = imgs_u8.shape
    out = np.empty((n, h, w, 3), np.float32)
    get_lib().dhd_normalize_images(
        imgs_u8, out, n, h, w, np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32))
    return out


def normalize_images_numpy(imgs_u8: np.ndarray, mean: np.ndarray,
                           std: np.ndarray) -> np.ndarray:
    swapped = np.asarray(imgs_u8, np.uint8)[..., ::-1].astype(np.float32)
    return (swapped - mean) / std


def project_cameras(points: np.ndarray, lidar2img: np.ndarray,
                    lidar2ego: np.ndarray, post_rot: np.ndarray,
                    post_tran: np.ndarray, hw: Tuple[int, int],
                    depth_range: Tuple[float, float]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched lidar->camera depth/height z-buffer projection.

    points: (P, >=3); lidar2img: (N, 4, 4); lidar2ego: (4, 4);
    post_rot: (N, 3, 3); post_tran: (N, 3).
    Returns (depth (N, H, W), height (N, H, W)).
    """
    n = lidar2img.shape[0]
    h, w = hw
    if (lidar2img.shape[1:] != (4, 4) or np.shape(lidar2ego) != (4, 4)
            or np.shape(post_rot) != (n, 3, 3)
            or np.shape(post_tran) != (n, 3) or points.shape[1] < 3):
        raise ValueError("project_cameras: inconsistent shapes")
    depth = np.zeros((n, h, w), np.float32)
    height = np.zeros((n, h, w), np.float32)
    get_lib().dhd_project_cameras(
        np.ascontiguousarray(points[:, :3], np.float32), points.shape[0],
        np.ascontiguousarray(lidar2img, np.float32),
        np.ascontiguousarray(lidar2ego, np.float32),
        np.ascontiguousarray(post_rot, np.float32),
        np.ascontiguousarray(post_tran, np.float32),
        n, h, w, depth_range[0], depth_range[1], depth, height)
    return depth, height


def project_cameras_numpy(points, lidar2img, lidar2ego, post_rot, post_tran,
                          hw, depth_range):
    """:func:`project_cameras` in numpy: a per-camera z-buffer with the same
    semantics (ties between equal depths may land differently)."""
    n = lidar2img.shape[0]
    h, w = hw
    depth = np.zeros((n, h, w), np.float32)
    height = np.zeros((n, h, w), np.float32)
    pts = points[:, :3].astype(np.float32)
    pts_ego_z = pts @ lidar2ego[2, :3] + lidar2ego[2, 3]
    for c in range(n):
        img = pts @ lidar2img[c, :3, :3].T + lidar2img[c, :3, 3]
        uvd = np.concatenate([img[:, :2] / img[:, 2:3], img[:, 2:3]], 1)
        uvd = uvd @ post_rot[c].T + post_tran[c]
        coor = np.round(uvd[:, :2])
        d = uvd[:, 2]
        kept = ((coor[:, 0] >= 0) & (coor[:, 0] < w) & (coor[:, 1] >= 0)
                & (coor[:, 1] < h) & (d >= depth_range[0])
                & (d < depth_range[1]))
        ck, dk, hk = coor[kept].astype(int), d[kept], pts_ego_z[kept]
        order = np.argsort((ck[:, 0] + ck[:, 1] * w) + dk / 100.0,
                           kind="stable")
        ck, dk, hk = ck[order], dk[order], hk[order]
        ranks = ck[:, 0] + ck[:, 1] * w
        keep = np.ones(len(ck), bool)
        keep[1:] = ranks[1:] != ranks[:-1]
        depth[c, ck[keep, 1], ck[keep, 0]] = dk[keep]
        height[c, ck[keep, 1], ck[keep, 0]] = hk[keep]
    return depth, height


def min_pool_nonzero(maps: np.ndarray, ds: int) -> np.ndarray:
    """(N, H, W) float32 -> (N, H//ds, W//ds): the least nonzero value of
    each ds x ds window, 1e5 where the window holds only zeros (the height
    loss's ``downsample_min_nonzero`` before its clamp)."""
    maps = np.ascontiguousarray(maps, np.float32)
    if maps.ndim != 3 or ds < 1:
        raise ValueError(f"want (N, H, W) maps and ds >= 1, got "
                         f"{maps.shape}, {ds}")
    n, h, w = maps.shape
    out = np.empty((n, h // ds, w // ds), np.float32)
    get_lib().dhd_min_pool_nonzero(maps, out, n, h, w, ds)
    return out


def min_pool_nonzero_numpy(maps: np.ndarray, ds: int) -> np.ndarray:
    n, h, w = maps.shape
    win = np.asarray(maps, np.float32)[:, :h // ds * ds, :w // ds * ds]
    win = win.reshape(n, h // ds, ds, w // ds, ds)
    return np.minimum(np.where(win == 0, np.float32(1e5), win)
                      .min(axis=(2, 4)), np.float32(1e5))
