"""Camera frustum geometry: pixel+depth -> ego-frame 3D points.

PyTorch counterpart of ``dhd_tpu/geometry/frustum.py`` (the LSS geometry
chain of the reference MGHS view transformer, lss_heightmap.py:105-231),
with the same op order so that fp32 results agree with the JAX package.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from bench_port.reference.config import GridConfig


def create_frustum(depth: GridConfig, input_size: Tuple[int, int],
                   downsample: int, sid: bool = False,
                   device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Build the (D, fH, fW, 3) frustum template of (u, v, d) triples.

    u spans [0, W_in-1] over fW columns, v spans [0, H_in-1] over fH rows, and
    d walks the depth bins (lss_heightmap.py:105-134).  With ``sid`` the depth
    spacing is log-uniform instead.
    """
    h_in, w_in = input_size
    fh, fw = h_in // downsample, w_in // downsample
    d = np.arange(depth.lower, depth.upper, depth.interval, dtype=np.float32)
    num_d = d.shape[0]
    if sid:
        idx = np.arange(num_d, dtype=np.float32)
        d = np.exp(np.log(depth.lower) + idx / (num_d - 1)
                   * np.log((depth.upper - 1.0) / depth.lower))
    u = np.linspace(0.0, w_in - 1.0, fw, dtype=np.float32)
    v = np.linspace(0.0, h_in - 1.0, fh, dtype=np.float32)
    grid = np.stack(
        [
            np.broadcast_to(u[None, None, :], (num_d, fh, fw)),
            np.broadcast_to(v[None, :, None], (num_d, fh, fw)),
            np.broadcast_to(d[:, None, None], (num_d, fh, fw)),
        ],
        axis=-1,
    ).astype(np.float32)
    return torch.from_numpy(grid).to(device)


def frustum_to_ego(frustum: torch.Tensor, sensor2ego: torch.Tensor,
                   intrins: torch.Tensor, post_rots: torch.Tensor,
                   post_trans: torch.Tensor, bda: torch.Tensor
                   ) -> torch.Tensor:
    """Map frustum (u, v, d) points to ego-frame xyz (get_ego_coor,
    lss_heightmap.py:179-231):

    1. undo image augmentation: p = post_rot^-1 (frustum - post_tran)
    2. (u, v, d) -> (du, dv, d), apply R_s2e @ K^-1, add t_s2e
    3. apply the BEV-augmentation rotation bda.

    Args:
      frustum: (D, fH, fW, 3)
      sensor2ego: (B, N, 4, 4) camera->ego (already key-ego aligned)
      intrins, post_rots: (B, N, 3, 3); post_trans: (B, N, 3)
      bda: (B, 3, 3)
    Returns:
      (B, N, D, fH, fW, 3) ego-frame coordinates.
    """
    pts = frustum[None, None] - post_trans[:, :, None, None, None, :]
    # inv_ex: the same factorisation as inv without its error check, which
    # waits for the device
    inv_post = torch.linalg.inv_ex(post_rots).inverse
    pts = torch.einsum("bnij,bndhwj->bndhwi", inv_post, pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    combine = torch.einsum("bnij,bnjk->bnik", sensor2ego[:, :, :3, :3],
                           torch.linalg.inv_ex(intrins).inverse)
    pts = torch.einsum("bnij,bndhwj->bndhwi", combine, pts)
    pts = pts + sensor2ego[:, :, None, None, None, :3, 3]
    return torch.einsum("bij,bndhwj->bndhwi", bda, pts)


def get_mlp_input(sensor2ego: torch.Tensor, intrins: torch.Tensor,
                  post_rots: torch.Tensor, post_trans: torch.Tensor,
                  bda: torch.Tensor) -> torch.Tensor:
    """27-dim camera embedding fed to the HeightNet SE gates, laid out as
    MGHS.get_mlp_input (lss_heightmap.py:493-526):
    [fx, fy, cx, cy, pr00, pr01, pt0, pr10, pr11, pt1,
     bda00, bda01, bda10, bda11, bda22, flat(sensor2ego[:3, :4])].

    Returns (B, N, 27).
    """
    b, n = sensor2ego.shape[:2]
    bda_n = bda[:, None].expand(b, n, 3, 3)
    feats = torch.stack([
        intrins[:, :, 0, 0], intrins[:, :, 1, 1],
        intrins[:, :, 0, 2], intrins[:, :, 1, 2],
        post_rots[:, :, 0, 0], post_rots[:, :, 0, 1], post_trans[:, :, 0],
        post_rots[:, :, 1, 0], post_rots[:, :, 1, 1], post_trans[:, :, 1],
        bda_n[:, :, 0, 0], bda_n[:, :, 0, 1],
        bda_n[:, :, 1, 0], bda_n[:, :, 1, 1], bda_n[:, :, 2, 2],
    ], dim=-1)
    s2e = sensor2ego[:, :, :3, :].reshape(b, n, 12)
    return torch.cat([feats, s2e], dim=-1)
