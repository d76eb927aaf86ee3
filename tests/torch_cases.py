"""Pieces the port's tests share.  No JAX here: the card's test modules,
which run without the JAX package (``--noconftest``), import it.

- :func:`tiny_dhd_l`: the tiny DHD-L-shaped configuration;
- :func:`full_fp32`: cuDNN and cuBLAS without TF32, for fp32 on the card
  against the CPU;
- :func:`launches` and :func:`swin_launches`: the kernels' launches
  counted, and those a Swin backbone makes;
- :func:`chain_share`: B5's two Swin block launches held bit for bit
  against the block's chain they stand for (``chip_variants.
  window_norm_chain``, ``residual_norm_chain``);
- the holds of the kernels at real inputs (a served plan, a DHD-L-sized
  map, a train step's own calls), each at its bar: :func:`check_pool`,
  :func:`check_plan`, :func:`check_cost_volume`, :func:`ln_share`,
  :func:`attention_share`;
- :func:`write_nuscenes_fixture`: samples in nuScenes' format on disk.

The cases' inputs and the shared bars come from ``chip_variants.py``, which
times the kernels at the same inputs.
"""
import contextlib
import dataclasses
import math
import os
import pickle

import numpy as np
import torch

from chip_variants import (CV_ATOL, CV_RTOL, POOL_ULP_TOL, TERM_TOL,
                           bf16_ulp_at, bf16_ulp_diff, bits_apart,
                           residual_norm_chain, sum_error_share,
                           window_norm_chain)
from dhd_tpu_torch.ops import (cv_cost_plain, mghs_pool_cuda,
                               mghs_pool_plan_plain, stereo_cost_volume_cuda)
from dhd_tpu_torch.ops.mghs_pool_cuda import pool_plan_cuda, pool_plan_plain
from dhd_tpu_torch.profiling import kernel_launches

POOL_F32_ATOL = 1e-5        # fp32 B1 vs the exact sums, plus 2^-20 of terms
LN_F32_ATOL = 1e-5          # fp32 B5 vs plain, plus 2^-20 of the terms
ATTN_ULP_TOL = 4            # bf16 B4 vs plain, in bf16 ulps of the output's
#                             peak: the bar the TPU kernel held against XLA
ATTN_F32_TOL = 1e-5         # fp32 B4 vs plain: atol and rtol


def tiny_dhd_l(get_config):
    """``dhd_tiny_stereo`` at 64x192 with a Swin-B-shaped backbone (embed
    16, depths (1, 1, 2, 1), heads (1, 2, 4, 8), window 4) and the FPN_LSS
    image neck (tests/test_stereo_model.py:145-158); the same replace for
    either package's config.  ``sfa_in_channels`` is the SFA's real input,
    BEV neck 64 + voxel encoders 64 (flax infers it; the port builds it)."""
    base = get_config("dhd_tiny_stereo")
    return dataclasses.replace(
        base, vt=dataclasses.replace(base.vt, input_size=(64, 192)),
        backbone="swin_base", swin_embed_dims=16, swin_depths=(1, 1, 2, 1),
        swin_num_heads=(1, 2, 4, 8), swin_window=4, img_neck="fpn_lss",
        img_neck_in_channels=(64, 128),
        img_neck_out_channels=base.vt.in_channels, sfa_in_channels=128)


def launches(names=None) -> dict:
    """The kernel wrappers' launches since the last ``profiling.reset()``:
    those that launched, of ``names`` where given."""
    return {k: v for k, v in kernel_launches().items()
            if v and (names is None or k in names)}


def swin_launches(cfg, frames: int, stage0_frames: int = 0,
                  train: bool = False) -> dict:
    """B4's and B5's launches when ``frames`` images run ``cfg``'s whole
    Swin and ``stage0_frames`` only its patch embedding and stage 0 (the
    extra stereo frame), outside autograd: a window attention a block; a
    LayerNorm for the patch embedding, one a patch merge and one an
    output stage; and a block's two LayerNorms, which carry its window
    maps and attention residual (``swin_window_norm_cuda``,
    ``swin_residual_norm_cuda``) where its DropPath keeps both branches
    whole: every block in eval or at DropPath rate 0 (DHD-L's whole Swin:
    24 attentions, 6 plain LayerNorms and 24 of each fused one); with
    ``train``, in training at the Swin's own rates (rising from 0 to 0.1),
    only the first block, whose rate is 0, and the other blocks' two
    LayerNorms launch plain B5."""
    d = cfg.swin_depths
    fused_whole, fused_stage0 = (1, 1) if train else (sum(d), d[0])
    whole = (1 + 2 * sum(d) + len(d) - 1 + len(cfg.swin_out_indices)
             - 2 * fused_whole)
    fused = frames * fused_whole + stage0_frames * fused_stage0
    return {"window_attention_cuda": frames * sum(d) + stage0_frames * d[0],
            "fused_layer_norm_cuda": frames * whole
            + stage0_frames * (1 + 2 * d[0] - 2 * fused_stage0),
            "swin_window_norm_cuda": fused,
            "swin_residual_norm_cuda": fused}


def chain_share(got, want) -> float:
    """A fused Swin block launch against its chain, held bit for bit, as a
    share of that bar: 0 where every element's bits agree, else 1 plus
    the elements that differ."""
    if torch.is_tensor(got):
        got, want = (got,), (want,)
    apart = sum(bits_apart(g, w) for g, w in zip(got, want))
    return float(apart + 1) if apart else 0.0


@contextlib.contextmanager
def full_fp32():
    """cuDNN and cuBLAS in full fp32 inside (no TF32): the fp32 card-vs-CPU
    comparisons.  Outside, PyTorch's defaults hold."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def check_pool(depth, feat, band_mask, plan, loose=False):
    """B1 against its plain version: bf16 within ``POOL_ULP_TOL`` bf16 ulp
    (``loose``, DHD-L, whose pillars sum ~4x DHD-M's points, where a sum
    that nearly cancels is many of its own ulps off: or within one ulp
    plus 2^-20 of the summed |terms|); fp32 within 1e-5 plus 2^-20 of the
    terms of the plain version's exact (float64) sums, since in fp32 the
    plain version rounds about as much as the kernel, in another order.
    One launch; some voxel not zero."""
    before = kernel_launches()["mghs_pool_cuda"]
    got = mghs_pool_cuda(depth, feat, band_mask, plan)
    torch.cuda.synchronize()
    assert kernel_launches()["mghs_pool_cuda"] == before + 1
    terms = mghs_pool_plan_plain(depth, feat.abs(), band_mask, plan)
    if depth.dtype == torch.float32:
        exact = mghs_pool_plan_plain(depth, feat, band_mask, plan,
                                     acc_dtype=torch.float64)
        share = max(sum_error_share(g, w, t, POOL_F32_ATOL)
                    for g, w, t in zip(got, exact, terms))
        assert share <= 1, f"{share:.3f} of the bar from the exact sums"
    else:
        want = mghs_pool_plan_plain(depth, feat, band_mask, plan)
        ulps = max(bf16_ulp_diff(g, w) for g, w in zip(got, want))
        share = max(sum_error_share(g, w, t)
                    for g, w, t in zip(got, want, terms))
        assert ulps <= POOL_ULP_TOL or (loose and share <= 1), (
            f"{ulps} bf16 ulps, {share:.3f} of one ulp plus 2^-20 of the "
            f"terms")
    assert float(got[1].float().abs().sum()) > 0


def check_pool_repeats(depth, feat, band_mask, plan):
    """Two calls of B1 give the same bits."""
    first = mghs_pool_cuda(depth, feat, band_mask, plan)
    second = mghs_pool_cuda(depth, feat, band_mask, plan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def check_plan(keys, plan):
    """B1's plan kernels on the sorted keys of ``keys`` (vt, PoolIndices,
    cams shape) against their plain version: every table and list equal,
    and equal to ``plan``'s, the plan served from the same keys.  One
    launch."""
    vt, idx, shape = keys
    key_s, order = torch.sort(idx.key, stable=True)
    args = (key_s, order, idx.seg_vox, idx.num_seg_vox, shape,
            vt.z_fine.size)
    before = kernel_launches()["pool_plan_cuda"]
    got = pool_plan_cuda(*args)
    assert kernel_launches()["pool_plan_cuda"] == before + 1
    want = pool_plan_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got[:5], want[:5]))
    assert got[5] == want[5]
    assert all(torch.equal(g, w) for g, w in zip(got, (
        plan.dix_s, plan.z_s, plan.starts, plan.tasks, plan.splits)))


def _warp0_exact(prev, uf, vf, idx):
    """Channel 0 of ``prev`` warped bilinearly (zero padding) to the
    samples ``idx`` (index tensors over (BN, D, Hs, Ws)) in float64, and
    the sum of its terms' magnitudes."""
    _, hs, ws, _ = prev.shape
    b = idx[0]
    u, v = uf[idx].double(), vf[idx].double()
    x0, y0 = torch.floor(u), torch.floor(v)
    val, terms = torch.zeros_like(u), torch.zeros_like(u)
    for dy, wy in ((0, 1 - (v - y0)), (1, v - y0)):
        for dx, wx in ((0, 1 - (u - x0)), (1, u - x0)):
            yy, xx = y0.long() + dy, x0.long() + dx
            inside = (yy >= 0) & (yy < hs) & (xx >= 0) & (xx < ws)
            t = prev[b, yy.clamp(0, hs - 1), xx.clamp(0, ws - 1), 0]
            t = torch.where(inside, t.double() * wx * wy, 0.0)
            val, terms = val + t, terms + t.abs()
    return val, terms


def check_cost_volume(prev, curr, uf, vf, bias):
    """B3 against its plain version.  The bias goes where the warped
    channel 0 is exactly 0: the two may put it on other samples only
    where the exact warped value is within 2^-20 of its terms (zero in one
    order of the fp32 sum only).  Each pixel whose samples agree holds its
    depth softmax within ``CV_ATOL`` + ``CV_RTOL`` of the plain one's.
    One launch."""
    before = kernel_launches()["stereo_cost_volume_cuda"]
    cost_k = stereo_cost_volume_cuda(prev, curr, uf, vf, bias)
    torch.cuda.synchronize()
    assert kernel_launches()["stereo_cost_volume_cuda"] == before + 1
    cost_p = cv_cost_plain(prev, curr, uf, vf, bias)
    no_bias = cv_cost_plain(prev, curr, uf, vf, 0.0)
    flipped = ((cost_p - no_bias) > bias / 2) != ((cost_k - no_bias)
                                                  > bias / 2)
    flips = flipped.nonzero(as_tuple=True)
    if flips[0].numel():
        near, terms = _warp0_exact(prev, uf, vf, flips)
        # no terms (every tap off the image or zero): 0 in any order
        share = float(torch.where(terms > 0, near.abs() / terms,
                                  math.inf).max())
        assert share <= TERM_TOL, (
            f"bias on {flips[0].numel()} other samples, the exact warped "
            f"channel 0 there up to {share:.3e} of its terms")
    same = ~flipped.any(1, keepdim=True)
    p_k, p_p = torch.softmax(-cost_k, 1), torch.softmax(-cost_p, 1)
    assert bool((((p_k - p_p).abs() <= CV_ATOL + CV_RTOL * p_p.abs())
                 | ~same).all())


def ln_share(y_k, y_p, x, w, b, eps=1e-6) -> float:
    """B5 against its plain version: the largest error as a share of one
    bf16 ulp (fp32: ``LN_F32_ATOL``) plus 2^-20 of the terms, (|x| + mean
    |x|)·|mul| + |bias|.  mean |x| is the magnitude of mu's terms: where a
    row's mean cancels to near 0 (a row already normalised), mu's fp32
    rounding follows mean |x|, not |mu|."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0)
    mul = (torch.rsqrt(var + eps) * w).abs()
    terms = (xf.abs() + xf.abs().mean(-1, keepdim=True)) * mul + b.abs()
    return sum_error_share(y_k, y_p, terms, LN_F32_ATOL
                           if x.dtype == torch.float32 else None)


def attention_share(out_k, out_p) -> float:
    """B4 against its plain version, as a share of its bar: bf16 within
    ``ATTN_ULP_TOL`` bf16 ulps of the output's peak; fp32 within
    ``ATTN_F32_TOL`` (atol and rtol)."""
    d = (out_k.float() - out_p.float()).abs()
    if out_k.dtype == torch.bfloat16:
        return float(d.max()) / (ATTN_ULP_TOL * bf16_ulp_at(out_p))
    return float((d / (ATTN_F32_TOL * (1 + out_p.abs()))).max())


def occupancy_scene(seed: int = 0, shape=(200, 200, 16)):
    """A class grid like Occ3D's: drivable ground and sidewalk slabs,
    buildings and vegetation at the edges, cars and other objects on the
    road, free above."""
    rng = np.random.default_rng(seed)
    gt = np.full(shape, 17, np.uint8)
    gt[:, :, :2] = 11
    gt[:, 130:, :3] = 13
    gt[:, 170:, :12] = 15
    gt[:25, :, :9] = 16
    for _ in range(60):
        x, y = rng.integers(20, 180, 2)
        w, l, h = rng.integers(2, 6), rng.integers(4, 12), rng.integers(3, 6)
        gt[x:x + w, y:y + l, 2:2 + h] = rng.integers(1, 11)
    return gt


def write_nuscenes_fixture(root, n_samples: int = 2, img_wh=(1600, 900),
                           grid=(200, 200, 16)):
    """``n_samples`` samples of one scene in nuScenes' format under
    ``root``: six JPEG cameras at nuScenes' 1600x900 with nuScenes-like
    intrinsics, a 34,720-point lidar sweep, Occ3D ``labels.npz`` and the
    infos pkl, whose path it returns."""
    from PIL import Image

    from dhd_tpu_torch.data.nuscenes import CAM_NAMES

    rng = np.random.default_rng(0)
    infos = []
    for i in range(n_samples):
        cams = {}
        for ci, cam in enumerate(CAM_NAMES):
            path = os.path.join(root, f"{i}_{cam}.jpg")
            Image.fromarray(rng.integers(
                0, 256, (img_wh[1], img_wh[0], 3), dtype=np.uint8)).save(
                path, quality=90)
            yaw = 2 * math.pi * ci / len(CAM_NAMES)
            cams[cam] = {
                "data_path": path,
                "cam_intrinsic": np.array([[1266.4, 0, 816.3],
                                           [0, 1266.4, 491.5], [0, 0, 1]]),
                "sensor2ego_rotation": [math.cos(yaw / 2 - math.pi / 4),
                                        0, 0, math.sin(yaw / 2
                                                       - math.pi / 4)],
                "sensor2ego_translation": [1.7, 0.0, 1.5],
                "ego2global_rotation": [1.0, 0, 0, 0],
                "ego2global_translation": [600.0 + 4.0 * i, 1600.0, 0.0]}
        lidar = os.path.join(root, f"lidar_{i}.bin")
        rng.uniform(-50, 50, (34720, 5)).astype(np.float32).tofile(lidar)
        occ_dir = os.path.join(root, "gts", str(i))
        os.makedirs(occ_dir, exist_ok=True)
        np.savez(os.path.join(occ_dir, "labels.npz"),
                 semantics=occupancy_scene(i, grid),
                 mask_lidar=(rng.random(grid) < 0.5).astype(np.uint8),
                 mask_camera=(rng.random(grid) < 0.7).astype(np.uint8))
        infos.append({
            "token": f"tok{i}", "timestamp": 1_000_000 * i,
            "scene_token": "scene0", "lidar_path": lidar,
            "lidar2ego_rotation": [0.7071, 0, 0, 0.7071],
            "lidar2ego_translation": [0.94, 0.0, 1.84],
            "ego2global_rotation": [1.0, 0, 0, 0],
            "ego2global_translation": [600.0 + 4.0 * i, 1600.0, 0.0],
            "occ_path": occ_dir, "cams": cams})
    pkl = os.path.join(root, "infos.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"infos": infos, "metadata": {"version": "fixture"}}, f)
    return pkl
