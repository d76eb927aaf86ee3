"""Host-side preprocessing pipeline (the PrepareImageInputs /
LoadAnnotationsBEVDepth / LoadOccGTFromFile / PointToMultiViewDepthandHeight
stack, datasets/pipelines/loading.py + loading_new.py) in plain numpy/PIL:
a copy of ``dhd_tpu/data/pipeline.py``, batch for batch the same arrays.

Produces the frames-major batch dicts the models consume.  PIL is imported
where an image is read: its resize and rotate are what the reference
feeds the model, and a re-implementation would not match them bit for bit.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dhd_tpu_torch.config import ModelConfig
from .nuscenes import CAM_NAMES, load_lidar_points, pose_to_mat, quat_to_rot

# mmcv imnormalize stats (loading.py:17-24).  The reference opens images with
# PIL (RGB) then calls imnormalize(to_rgb=True), which channel-swaps *again*
# (a known BEVDet quirk) — pretrained weights therefore see BGR-ordered
# channels normalized with these stats.  We replicate exactly.
IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)


def normalize_img(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W, 3) float32 with the reference quirk."""
    img = np.asarray(img)[..., ::-1].astype(np.float32)    # RGB -> BGR swap
    return (img - IMG_MEAN) / IMG_STD


def sample_augmentation(src_hw: Tuple[int, int], input_hw: Tuple[int, int],
                        is_train: bool, rng: Optional[np.random.Generator],
                        resize_lim=(-0.06, 0.11), rot_lim=(-5.4, 5.4),
                        crop_h=(0.0, 0.0), rand_flip=True,
                        resize_test: float = 0.0):
    """Per-camera aug parameters (loading.py:55-94)."""
    h, w = src_hw
    f_h, f_w = input_hw
    if is_train:
        resize = float(f_w) / float(w) + rng.uniform(*resize_lim)
        new_w, new_h = int(w * resize), int(h * resize)
        crop_h_v = int((1 - rng.uniform(*crop_h)) * new_h) - f_h
        crop_w = int(rng.uniform(0, max(0, new_w - f_w)))
        crop = (crop_w, crop_h_v, crop_w + f_w, crop_h_v + f_h)
        flip = bool(rand_flip and rng.choice([0, 1]))
        rotate = float(rng.uniform(*rot_lim))
    else:
        resize = float(f_w) / float(w) + resize_test
        new_w, new_h = int(w * resize), int(h * resize)
        crop_h_v = int((1 - np.mean(crop_h)) * new_h) - f_h
        crop_w = int(max(0, new_w - f_w) / 2)
        crop = (crop_w, crop_h_v, crop_w + f_w, crop_h_v + f_h)
        flip, rotate = False, 0.0
    return resize, (new_w, new_h), crop, flip, rotate


def _rot2(deg_rad: float) -> np.ndarray:
    c, s = np.cos(deg_rad), np.sin(deg_rad)
    return np.array([[c, s], [-s, c]], np.float32)


def transform_image(img, resize_dims, crop, flip, rotate):
    """Apply resize/crop/flip/rotate to a PIL image (loading.py:96-103)."""
    img = img.resize(resize_dims)
    img = img.crop(crop)
    if flip:
        from PIL import Image
        img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
    img = img.rotate(rotate)
    return img


def aug_homography(resize, crop, flip, rotate
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """post_rot (2,2), post_tran (2,) tracking the image aug as a homography
    (loading.py:111-146)."""
    post_rot = np.eye(2, dtype=np.float32) * resize
    post_tran = -np.asarray(crop[:2], np.float32)
    if flip:
        a = np.array([[-1, 0], [0, 1]], np.float32)
        b = np.array([crop[2] - crop[0], 0], np.float32)
        post_rot = a @ post_rot
        post_tran = a @ post_tran + b
    a = _rot2(rotate / 180.0 * np.pi)
    b = np.array([crop[2] - crop[0], crop[3] - crop[1]], np.float32) / 2.0
    b = a @ (-b) + b
    post_rot = a @ post_rot
    post_tran = a @ post_tran + b
    return post_rot, post_tran


def bda_matrix(rotate_deg: float, scale: float, flip_dx: bool, flip_dy: bool
               ) -> np.ndarray:
    """BEV-augmentation rotation matrix (loading.py:316-357)."""
    ang = rotate_deg / 180.0 * np.pi
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    scale_m = np.eye(3, dtype=np.float32) * scale
    flip = np.eye(3, dtype=np.float32)
    if flip_dx:
        flip = flip @ np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
    if flip_dy:
        flip = flip @ np.diag([1.0, -1.0, 1.0]).astype(np.float32)
    return flip @ (scale_m @ rot)


def load_occ_gt(occ_gt_path: str, flip_dx: bool = False,
                flip_dy: bool = False) -> Dict[str, np.ndarray]:
    """labels.npz -> semantics/mask_lidar/mask_camera with bda flips
    (loading.py:503-532)."""
    labels = np.load(os.path.join(occ_gt_path, "labels.npz"))
    sem = labels["semantics"]
    ml = labels["mask_lidar"]
    mc = labels["mask_camera"]
    if flip_dx:
        sem, ml, mc = sem[::-1], ml[::-1], mc[::-1]
    if flip_dy:
        sem, ml, mc = sem[:, ::-1], ml[:, ::-1], mc[:, ::-1]
    return {"voxel_semantics": np.ascontiguousarray(sem),
            "mask_lidar": np.ascontiguousarray(ml),
            "mask_camera": np.ascontiguousarray(mc)}


def zbuffer_scatter(coor: np.ndarray, depth_key: np.ndarray,
                    values: np.ndarray, height: int, width: int
                    ) -> np.ndarray:
    """Keep the nearest point per pixel (loading.py:408-436 sort trick)."""
    out = np.zeros((height, width), np.float32)
    if coor.shape[0] == 0:
        return out
    ranks = coor[:, 0] + coor[:, 1] * width
    order = np.argsort(ranks + depth_key / 100.0, kind="stable")
    coor, values, ranks = coor[order], values[order], ranks[order]
    keep = np.ones(coor.shape[0], bool)
    keep[1:] = ranks[1:] != ranks[:-1]
    coor, values = coor[keep], values[keep]
    out[coor[:, 1].astype(int), coor[:, 0].astype(int)] = values
    return out


def points_to_depth_height(points_lidar: np.ndarray, curr: dict,
                           cam_name: str, intrin: np.ndarray,
                           post_rot: np.ndarray, post_tran: np.ndarray,
                           img_hw: Tuple[int, int],
                           depth_range: Tuple[float, float]
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Project lidar into one camera's depth + height maps
    (loading_new.py:101-185).  Height = point z in the lidar-ego frame.
    """
    h, w = img_hw
    lidar2lidarego = pose_to_mat(curr["lidar2ego_rotation"],
                                 curr["lidar2ego_translation"])
    lidarego2global = pose_to_mat(curr["ego2global_rotation"],
                                  curr["ego2global_translation"])
    cam_info = curr["cams"][cam_name]
    cam2camego = pose_to_mat(cam_info["sensor2ego_rotation"],
                             cam_info["sensor2ego_translation"])
    camego2global = pose_to_mat(cam_info["ego2global_rotation"],
                                cam_info["ego2global_translation"])
    lidar2cam = np.linalg.inv(camego2global @ cam2camego) @ \
        (lidarego2global @ lidar2lidarego)
    cam2img = np.eye(4, dtype=np.float32)
    cam2img[:3, :3] = intrin
    lidar2img = cam2img @ lidar2cam

    pts = points_lidar[:, :3].astype(np.float32)
    pts_img = pts @ lidar2img[:3, :3].T + lidar2img[:3, 3]
    pts_ego = pts @ lidar2lidarego[:3, :3].T + lidar2lidarego[:3, 3]
    uvd = np.concatenate(
        [pts_img[:, :2] / pts_img[:, 2:3], pts_img[:, 2:3]], axis=1)
    uvd = uvd @ post_rot.T + post_tran

    coor = np.round(uvd[:, :2])
    depth = uvd[:, 2]
    kept = ((coor[:, 0] >= 0) & (coor[:, 0] < w) & (coor[:, 1] >= 0)
            & (coor[:, 1] < h) & (depth >= depth_range[0])
            & (depth < depth_range[1]))
    coor_k = coor[kept]
    depth_k = depth[kept]
    height_k = pts_ego[kept, 2]
    depth_map = zbuffer_scatter(coor_k, depth_k, depth_k, h, w)
    height_map = zbuffer_scatter(coor_k, depth_k, height_k, h, w)
    return depth_map, height_map


class SamplePipeline:
    """Assemble one training/eval sample into the model batch layout."""

    def __init__(self, cfg: ModelConfig, is_train: bool,
                 data_root: str = "", bda_aug: Optional[dict] = None,
                 seed: Optional[int] = None):
        self.cfg = cfg
        self.is_train = is_train
        self.data_root = data_root
        self.bda_aug = bda_aug or dict(rot_lim=(0.0, 0.0),
                                       scale_lim=(1.0, 1.0),
                                       flip_dx_ratio=0.5, flip_dy_ratio=0.5)
        self.rng = np.random.default_rng(seed)

    def _resolve(self, path: str) -> str:
        if os.path.isabs(path) or not self.data_root:
            return path
        return os.path.join(self.data_root, path)

    def __call__(self, sample: dict) -> dict:
        from PIL import Image

        cfg = self.cfg
        vt = cfg.vt
        curr = sample["curr"]
        frames = [curr] + list(sample.get("adjacent", []))
        n_frames = len(frames)
        n_cams = cfg.num_cams
        h_in, w_in = vt.input_size

        if self.is_train:
            rot_bda = float(self.rng.uniform(*self.bda_aug["rot_lim"]))
            scale_bda = float(self.rng.uniform(*self.bda_aug["scale_lim"]))
            flip_dx = bool(self.rng.uniform() <
                           self.bda_aug["flip_dx_ratio"])
            flip_dy = bool(self.rng.uniform() <
                           self.bda_aug["flip_dy_ratio"])
        else:
            rot_bda, scale_bda, flip_dx, flip_dy = 0.0, 1.0, False, False
        bda = bda_matrix(rot_bda, scale_bda, flip_dx, flip_dy)

        imgs = np.zeros((n_frames, n_cams, h_in, w_in, 3), np.float32)
        s2e = np.zeros((n_frames, n_cams, 4, 4), np.float32)
        e2g = np.zeros((n_frames, n_cams, 4, 4), np.float32)
        intr = np.zeros((n_frames, n_cams, 3, 3), np.float32)
        post_rots = np.tile(np.eye(3, dtype=np.float32),
                            (n_frames, n_cams, 1, 1))
        post_trans = np.zeros((n_frames, n_cams, 3), np.float32)
        aug_params = []

        for ci, cam in enumerate(CAM_NAMES[:n_cams]):
            cam_info = curr["cams"][cam]
            img = Image.open(self._resolve(cam_info["data_path"]))
            aug = sample_augmentation(
                (img.height, img.width), (h_in, w_in), self.is_train,
                self.rng)
            resize, resize_dims, crop, flip, rotate = aug
            aug_params.append(aug)
            pr2, pt2 = aug_homography(resize, crop, flip, rotate)
            for fi, info in enumerate(frames):
                ci_info = info["cams"][cam]
                if fi == 0:
                    im = img
                else:
                    im = Image.open(self._resolve(ci_info["data_path"]))
                im = transform_image(im, resize_dims, crop, flip, rotate)
                imgs[fi, ci] = normalize_img(im)
                s2e[fi, ci] = pose_to_mat(ci_info["sensor2ego_rotation"],
                                          ci_info["sensor2ego_translation"])
                e2g[fi, ci] = pose_to_mat(ci_info["ego2global_rotation"],
                                          ci_info["ego2global_translation"])
                intr[fi, ci] = np.asarray(cam_info["cam_intrinsic"],
                                          np.float32)
                post_rots[fi, ci, :2, :2] = pr2
                post_trans[fi, ci, :2] = pt2

        batch = {"bda": bda}
        if cfg.temporal:
            batch.update(intrins=intr, post_rots=post_rots,
                         post_trans=post_trans)
            batch["imgs"] = imgs
            batch["sensor2ego"] = s2e
            batch["ego2global"] = e2g
            # key-ego alignment + cur->adj sensor transforms precomputed
            # host-side in float64 (the reference's .double() semantics,
            # bevdet.py:72-74): nuScenes global translations are O(1000 m)
            # and the compositions below subtract near-equal poses.
            s2e64 = s2e.astype(np.float64)
            e2g64 = e2g.astype(np.float64)
            g2k = np.linalg.inv(e2g64[0, 0])
            batch["sensor2keyego"] = (
                g2k @ e2g64 @ s2e64).astype(np.float32)
            cam2glob = e2g64 @ s2e64                      # (F, N, 4, 4)
            # curr2adjsensor[f]: frame-f camera -> frame-(f+1) camera
            batch["curr2adjsensor"] = (
                np.linalg.inv(cam2glob[1:]) @ cam2glob[:-1]
            ).astype(np.float32)
        else:
            batch.update(intrins=intr[0], post_rots=post_rots[0],
                         post_trans=post_trans[0])
            batch["imgs"] = imgs[0]
            # single-frame: key-ego == own ego; align like bevdet.py:60-78
            key = np.linalg.inv(e2g[0, :1].astype(np.float64))
            batch["sensor2keyego"] = (
                key @ e2g[0].astype(np.float64) @ s2e[0].astype(np.float64)
            ).astype(np.float32)
            batch["ego2global"] = e2g[0]

        if sample.get("occ_gt_path"):
            batch.update(load_occ_gt(self._resolve(sample["occ_gt_path"]),
                                     flip_dx, flip_dy))

        if self.is_train and sample.get("lidar_path"):
            from dhd_tpu_torch.native import project_cameras
            pts = load_lidar_points(self._resolve(sample["lidar_path"]))
            lidar2ego = pose_to_mat(curr["lidar2ego_rotation"],
                                    curr["lidar2ego_translation"])
            lidarego2global = pose_to_mat(curr["ego2global_rotation"],
                                          curr["ego2global_translation"])
            l2img = np.zeros((n_cams, 4, 4), np.float32)
            for ci, cam in enumerate(CAM_NAMES[:n_cams]):
                cam_info = curr["cams"][cam]
                cam2camego = pose_to_mat(cam_info["sensor2ego_rotation"],
                                         cam_info["sensor2ego_translation"])
                camego2global = pose_to_mat(cam_info["ego2global_rotation"],
                                            cam_info["ego2global_translation"])
                lidar2cam = np.linalg.inv(camego2global @ cam2camego) @ \
                    (lidarego2global @ lidar2ego)
                cam2img = np.eye(4, dtype=np.float32)
                cam2img[:3, :3] = intr[0, ci]
                l2img[ci] = cam2img @ lidar2cam
            d_maps, h_maps = project_cameras(
                pts, l2img, lidar2ego, post_rots[0], post_trans[0],
                (h_in, w_in), (vt.depth.lower, vt.depth.upper))
            batch["gt_depth"] = d_maps
            batch["gt_height"] = h_maps
        return batch


def collate(samples: List[dict]) -> dict:
    """Stack per-sample dicts into a batch."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}
