"""Temporal + stereo DHD (DHD-M, DHD-L): counterpart of
``dhd_tpu/models/dhd_stereo.py`` (the reference's ``DHD_stereo``,
detectors/DHD_model.py:245-667, on the BEVDet4D/BEVStereo4D frame
protocol).

Two entry points:

* the streaming step ``model(batch, cache=...)``: ``batch`` holds the
  current frame only (imgs (B, N, H, W, 3), sensor2ego / ego2global
  (B, N, 4, 4), intrins, post_rots, post_trans, bda, optional pool_plan
  from :func:`build_stream_pool_plan` and cv_static from
  :func:`build_stream_cv_static`); the previous frame's stereo
  features and BEV/voxel grids come from ``cache`` (``{}`` on the first
  frame), and it returns ``(outputs, new_cache)``;
* the F-frame forward ``model(batch, with_prev=...)`` over a frames-major
  batch (imgs (B, F, N, H, W, 3), frame 0 the key frame), what the eval
  path runs and, in train mode, the training forward: gradients reach the
  key frame only, as in JAX (the history frames and the extra frame run
  under ``torch.no_grad``: JAX's stop-gradients; the cost volume has no
  gradient).

Each processed frame runs the MGHS transform with a stereo cost volume
against the previous frame's stride-4 features (kernel B3 on the GPU; the
features are ResNet-50's layer1 in DHD-M and Swin-B's un-normed stage 0 in
DHD-L), then the pre-process CustomResNets; the frames' grids are
concatenated on channels, [previous, current], and go through the DHD-S
fusion stack.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch

from dhd_tpu_torch import profiling
from dhd_tpu_torch.config import GridConfig, ModelConfig
from dhd_tpu_torch.device import device_constant, resolve_device
from dhd_tpu_torch.geometry import (create_frustum, inverse_3x3,
                                    rigid_inverse, rigid_relative)
from dhd_tpu_torch.ops import (PoolPlan, build_cv_static, grid_sample_2d,
                               stereo_cost_volume)

from .dhd import DHDNet, _as_tensor, build_batch_pool_plan, collapse_z

CacheDict = Dict[str, torch.Tensor]


def uncollapse_z(x: torch.Tensor, dz: int) -> torch.Tensor:
    """(B, Dy, Dx, Dz*C) -> (B, Dy, Dx, Dz, C): the inverse of
    :func:`collapse_z` (DHD_model.py:366-367)."""
    b, dy, dx, zc = x.shape
    return x.reshape(b, dy, dx, dz, zc // dz)


def shift_grid(dy: int, dx: int, curr_s2k: torch.Tensor,
               prev_s2k: torch.Tensor, bda: torch.Tensor,
               x_grid: GridConfig, y_grid: GridConfig) -> torch.Tensor:
    """Normalised BEV warp grid aligning a previous frame's BEV map to the
    key ego frame (bevdet4d.py:43-116).

    curr_s2k, prev_s2k: (B, 4, 4) front-camera sensor -> key ego of the two
    frames; bda (B, 3, 3).  Returns (B, Dy, Dx, 2) in [-1, 1].
    """
    b = curr_s2k.shape[0]
    dev, dt = curr_s2k.device, curr_s2k.dtype
    bda4 = torch.zeros((b, 4, 4), dtype=dt, device=dev)
    bda4[:, :3, :3] = bda
    bda4[:, 3, 3] = 1.0
    bda4_inv = torch.zeros_like(bda4)
    bda4_inv[:, :3, :3] = inverse_3x3(bda)
    bda4_inv[:, 3, 3] = 1.0
    # inv(bda4 @ prev_s2k), prev_s2k rigid: no general 4x4 inverse, which
    # would wait for the device
    keyego2adjego = bda4 @ curr_s2k @ rigid_inverse(prev_s2k) @ bda4_inv
    # BEV is 2D: drop z (rows and columns 0, 1, 3)
    k2a = torch.cat([keyego2adjego[:, :2], keyego2adjego[:, 3:]], dim=1)
    k2a = torch.cat([k2a[..., :2], k2a[..., 3:]], dim=-1)
    feat2bev = device_constant([[x_grid.interval, 0.0, x_grid.lower],
                                [0.0, y_grid.interval, y_grid.lower],
                                [0.0, 0.0, 1.0]], dev, dt)
    tf = torch.einsum("ij,bjk,kl->bil", inverse_3x3(feat2bev), k2a,
                      feat2bev)
    xs = torch.arange(dx, dtype=torch.float32, device=dev)
    ys = torch.arange(dy, dtype=torch.float32, device=dev)
    grid = torch.stack([xs[None, :].expand(dy, dx),
                        ys[:, None].expand(dy, dx),
                        torch.ones((dy, dx), device=dev)], dim=-1)
    warped = torch.einsum("bij,hwj->bhwi", tf, grid)
    return torch.stack([warped[..., 0] / (dx - 1.0),
                        warped[..., 1] / (dy - 1.0)], dim=-1) * 2.0 - 1.0


def stream_geometry(s2e: torch.Tensor, e2g: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sensor -> current-ego (key ego) and camera -> global transforms of
    one streamed frame; s2e, e2g (B, N, 4, 4) -> two (B, N, 4, 4)."""
    g2k_e2g = rigid_relative(e2g[:, :1].expand_as(e2g), e2g)
    return (torch.einsum("bnij,bnjk->bnik", g2k_e2g, s2e),
            torch.einsum("bnij,bnjk->bnik", e2g, s2e))


def frame_geometry(s2e: torch.Tensor, e2g: torch.Tensor,
                   prev_c2g: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """The geometry of a streamed frame: :func:`stream_geometry`'s two
    transforms and the current -> previous camera transform from the
    previous frame's camera -> global ``prev_c2g`` (None without one)."""
    s2k, cam2global = stream_geometry(s2e, e2g)
    k2s = None if prev_c2g is None else rigid_relative(prev_c2g, cam2global)
    return s2k, cam2global, k2s


def prepare_stereo_inputs(batch: Dict[str, Any],
                          device: Union[str, torch.device]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key-ego alignment and current -> adjacent sensor transforms of a
    frames-major batch (bevdet4d.py:208-288): sensor2keyego (B, F, N, 4, 4)
    and curr2adjsensor (B, F-1, N, 4, 4), frame f's camera -> frame f+1's.

    Takes the batch's host-fp64 ``sensor2keyego`` and ``curr2adjsensor``
    when it has both (the reference computes them in fp64,
    bevdet.py:72-74); otherwise composes them from sensor2ego / ego2global
    in fp32 with the cancellation-free rigid helpers.
    """
    def f32(k):
        return _as_tensor(batch[k], device, torch.float32)

    if "sensor2keyego" in batch and "curr2adjsensor" in batch:
        return f32("sensor2keyego"), f32("curr2adjsensor")
    s2e, e2g = f32("sensor2ego"), f32("ego2global")
    g2k_e2g = rigid_relative(e2g[:, :1, :1].expand_as(e2g), e2g)
    s2k = torch.einsum("bfnij,bfnjk->bfnik", g2k_e2g, s2e)
    e2g_rel = rigid_relative(e2g[:, 1:], e2g[:, :-1])
    c2a = torch.einsum("bfnij,bfnjk,bfnkl->bfnil", rigid_inverse(s2e[:, 1:]),
                       e2g_rel, s2e[:, :-1])
    return s2k, c2a


def build_stream_pool_plan(cfg: ModelConfig, batch: Dict[str, Any],
                           device: Optional[Union[str, torch.device]] = None
                           ) -> PoolPlan:
    """The pooling plan of a streamed frame's rig: the frame-relative
    sensor2keyego the streaming step computes, then
    :func:`build_batch_pool_plan`.  Geometry-only: a fixed rig computes it
    once and passes it as ``batch["pool_plan"]`` with every frame."""
    device = resolve_device(device)
    s2k, _ = stream_geometry(
        _as_tensor(batch["sensor2ego"], device, torch.float32),
        _as_tensor(batch["ego2global"], device, torch.float32))
    return build_batch_pool_plan(cfg, dict(batch, sensor2keyego=s2k),
                                 device=device)


def build_stream_cv_static(cfg: ModelConfig, batch: Dict[str, Any],
                           device: Optional[Union[str, torch.device]] = None
                           ) -> Dict[str, Any]:
    """The rig-static half of a streamed frame's stereo warp plan
    (dhd_stereo.py:492-510): frustum, intrinsics and image aug only, so a
    fixed rig computes it once, on the model's device, and passes it as
    ``batch["cv_static"]`` with every frame; the per-frame residual is
    :func:`~dhd_tpu_torch.ops.cv_plan_from_static`."""
    device = resolve_device(device)
    vt = cfg.vt
    with profiling.span("setup.cv_static", always=True):
        frustum = create_frustum(vt.depth, vt.input_size, 4, vt.sid,
                                 device=device)
        hs, ws = vt.input_size[0] // 4, vt.input_size[1] // 4
        return build_cv_static(
            frustum, *(_as_tensor(batch[k], device, torch.float32)
                       for k in ("intrins", "post_rots", "post_trans")),
            hs, ws)


class DHDStereoNet(DHDNet):
    """Temporal + stereo DHD (DHD-M, DHD-L); built, served and trained like
    :class:`~dhd_tpu_torch.models.DHDNet`."""
    temporal = True

    @functools.cached_property
    def _cv_frustum(self) -> torch.Tensor:
        """(D, Hs, Ws, 3) stride-4 frustum of the cost volume, made once:
        building it copies 12 MB from the host at DHD-M."""
        vt = self.cfg.vt
        return create_frustum(vt.depth, vt.input_size, 4, vt.sid,
                              device=self.device)

    def _cost_volume(self, prev_sf: Optional[torch.Tensor],
                     sf: torch.Tensor, k2s: Optional[torch.Tensor],
                     geom: Dict[str, torch.Tensor], b: int, n: int,
                     static: Optional[Dict[str, Any]] = None
                     ) -> torch.Tensor:
        """(B*N, D, Hs, Ws) depth probabilities of the current stereo
        features ``sf`` (B*N, Hs, Ws, Cs) against ``prev_sf``; zero without
        a previous frame (depthnet.py:396-403).  ``static`` is the rig's
        :func:`build_stream_cv_static`."""
        bn, hs, ws, cs = sf.shape
        with profiling.span("cost_volume"):
            if prev_sf is None:
                return torch.zeros((bn, self.cfg.vt.D, hs, ws),
                                   dtype=self.dtype, device=self.device)
            return self._graphs.call(
                "cost_volume", self._warped_cost, prev_sf, sf, k2s,
                geom["intrins"], geom["post_rots"], geom["post_trans"],
                static, b, n)

    def _warped_cost(self, prev_sf: torch.Tensor, sf: torch.Tensor,
                     k2s: torch.Tensor, intrins: torch.Tensor,
                     post_rots: torch.Tensor, post_trans: torch.Tensor,
                     static: Optional[Dict[str, Any]], b: int, n: int
                     ) -> torch.Tensor:
        """The cost volume against a previous frame: its warp plan, B3
        and the softmax."""
        cfg = self.cfg
        bn, hs, ws, cs = sf.shape
        cv = stereo_cost_volume(
            prev_sf.reshape(b, n, hs, ws, cs), sf.reshape(b, n, hs, ws, cs),
            self._cv_frustum, k2s, intrins, post_rots, post_trans,
            bias=cfg.depthnet_cfg.bias, method=cfg.cv_method, static=static)
        return cv.reshape(bn, -1, hs, ws).to(self.dtype)

    def _frame(self, imgs: torch.Tensor, geom: Dict[str, torch.Tensor],
               prev_sf: Optional[torch.Tensor],
               k2s: Optional[torch.Tensor],
               plan: Optional[PoolPlan] = None,
               cv_static: Optional[Dict[str, Any]] = None,
               generator: Optional[torch.Generator] = None):
        """One processed frame: encoder, cost volume, MGHS transform and
        pre-process nets.  imgs (B, N, H, W, 3); returns the transform's
        outputs with its grids pre-processed, and the frame's stereo
        features (B*N, Hs, Ws, Cs) channels-last, or None."""
        b, n, h, w, _ = imgs.shape
        x, sfeat = self._encode(
            imgs.permute(0, 1, 4, 2, 3).reshape(b * n, 3, h, w),
            generator=generator)
        sf = cv = None
        if self.cfg.stereo:
            sf = sfeat.permute(0, 2, 3, 1).contiguous()
            cv = self._cost_volume(prev_sf, sf, k2s, geom, b, n, cv_static)
        with profiling.span("view_transform"):
            out = self._unit("img_view_transformer",
                             x.reshape((b, n) + x.shape[1:]), geom, plan, cv,
                             generator)
        out["bev"], out["vox"] = self._pre_process(out["bev"], out["vox"])
        return out, sf

    def _pre_process(self, bev: torch.Tensor, vox: torch.Tensor):
        """collapse z -> one-block CustomResNet -> restore z, and the same
        over the BEV grid (DHD_model.py:360-368)."""
        if not self.cfg.pre_process:
            return bev, vox
        with profiling.span("pre_process"):
            bev = self._unit("pre_process_net", bev.permute(0, 3, 1, 2))[0]
            vz = self._unit("pre_process_net_3d",
                            collapse_z(vox).permute(0, 3, 1, 2))[0]
            return (bev.permute(0, 2, 3, 1),
                    uncollapse_z(vz.permute(0, 2, 3, 1),
                                 self.cfg.vt.z_fine.size))

    def _outputs(self, bev, vox, depth, height) -> Dict[str, torch.Tensor]:
        occ, occ_flat = self._fuse_and_predict(bev, vox)
        return {"occ_logits": occ, "occ_logits_flat": occ_flat,
                "depth": self._graphs.own(depth),
                "height": self._graphs.own(height)}

    def forward(self, batch: Dict[str, Any],
                cache: Optional[CacheDict] = None, with_prev: bool = True,
                generator: Optional[torch.Generator] = None):
        """The streaming step when ``cache`` is given (``{}`` for the
        first frame of a stream): returns ``(outputs, new_cache)``.
        Otherwise the F-frame forward over a frames-major batch;
        ``with_prev=False`` skips the history frames, with a zero cost
        volume and zero previous grids (the SequentialControlHook's early
        epochs).  Outputs, grad mode and ``generator`` as
        :meth:`DHDNet.forward`."""
        with profiling.span("forward"), torch.set_grad_enabled(
                self.training and torch.is_grad_enabled()):
            if cache is not None:
                with self._served("stream", batch, cache):
                    return self._streaming(batch, cache, generator)
            return self._frames(batch, with_prev, generator)

    def _streaming(self, batch: Dict[str, Any], cache: CacheDict,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[Dict[str, torch.Tensor], CacheDict]:
        """One streaming step (dhd_stereo.py:356-468).  Cache keys:
        stereo_feat (B*N, Hs, Ws, Cs) channels-last; bev (B, Dy, Dx, C) and
        vox (B, Dy, Dx, Dz, C) pooled in the previous frame's ego
        coordinates; cam2global (B, N, 4, 4) fp32 of the previous frame."""
        geom = self._geom(batch, ("intrins", "post_rots", "post_trans",
                                  "bda", "sensor2ego", "ego2global"))
        e2g = geom.pop("ego2global")
        prev_c2g = cache.get("cam2global")
        s2k, cam2global, k2s = self._graphs.call(
            "geometry", frame_geometry, geom.pop("sensor2ego"), e2g, prev_c2g)
        geom["sensor2keyego"] = s2k
        out, sf = self._frame(
            _as_tensor(batch["imgs"], self.device, self.dtype), geom,
            cache.get("stereo_feat"), k2s, batch.get("pool_plan"),
            batch.get("cv_static"), generator)
        bev, vox = out["bev"], out["vox"]

        if cache.get("bev") is None:
            prev_bev, prev_vox = torch.zeros_like(bev), torch.zeros_like(vox)
        else:
            with profiling.span("history_warp"):
                prev_bev, prev_vox = self._graphs.call(
                    "history_warp", self._warp_history, e2g, prev_c2g, s2k,
                    geom["bda"], cache["bev"], cache["vox"])
        outputs = self._outputs(torch.cat([prev_bev, bev], dim=-1),
                                torch.cat([prev_vox, vox], dim=-1),
                                out["depth"], out["height"])
        # the caller's: no later replay writes them
        own = self._graphs.own
        return outputs, {"stereo_feat": own(sf), "bev": own(bev),
                         "vox": own(vox), "cam2global": own(cam2global)}

    def _warp_history(self, e2g: torch.Tensor, prev_c2g: torch.Tensor,
                      s2k: torch.Tensor, bda: torch.Tensor,
                      bev: torch.Tensor, vox: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The previous frame's grids warped from its ego frame into the
        current one (shift_feature, bevdet4d.py:118-134)."""
        vt = self.cfg.vt
        prev_s2k_front = rigid_relative(e2g[:, 0], prev_c2g[:, 0])
        grid = shift_grid(vt.y.size, vt.x.size, s2k[:, 0], prev_s2k_front,
                          bda, vt.x, vt.y)
        return (grid_sample_2d(bev, grid),
                uncollapse_z(grid_sample_2d(collapse_z(vox), grid),
                             vt.z_fine.size))

    def _frames(self, batch: Dict[str, Any], with_prev: bool,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The F-frame forward (dhd_stereo.py:176-325): frames newest
        history first, the extra stereo reference frame contributing only
        its stride-4 feature.  Only the key frame records autograd: the
        others run under ``torch.no_grad`` (JAX's stop-gradients,
        dhd_tpu/models/dhd_stereo.py:234,285-287), in train mode all the
        same (their BatchNorms step, their dropout and DropPath draw), and
        there B4 and B5 launch and B1 runs outside its autograd
        Function."""
        cfg = self.cfg
        vt = cfg.vt
        num_frames = cfg.num_frames
        imgs = _as_tensor(batch["imgs"], self.device, self.dtype)
        if imgs.shape[1] != num_frames:
            raise ValueError(f"want {num_frames} frames, got {imgs.shape[1]}")
        s2k, c2a = prepare_stereo_inputs(batch, self.device)
        views = self._geom(batch, ("intrins", "post_rots", "post_trans"))
        bda = self._geom(batch, ("bda",))["bda"]

        bev_list, vox_list = [], []
        depth_key = height_key = None
        prev_sf = None
        grad = torch.is_grad_enabled()
        for fid in range(num_frames - 1, -1, -1):
            key_frame = fid == 0
            if not with_prev and not key_frame:
                continue
            with torch.set_grad_enabled(grad and key_frame):
                if cfg.stereo and fid == num_frames - 1:  # extra reference
                    b, n, h, w, _ = imgs[:, fid].shape
                    _, sfeat = self._encode(
                        imgs[:, fid].permute(0, 1, 4, 2, 3).reshape(
                            b * n, 3, h, w), stage0_only=True,
                        generator=generator)
                    prev_sf = sfeat.permute(0, 2, 3, 1).contiguous()
                    continue
                pool_fid = 0 if cfg.align_after_view_transformation else fid
                geom = {k: v[:, fid] for k, v in views.items()}
                geom.update(bda=bda, mlp_sensor2keyego=s2k[:, 0],
                            sensor2keyego=s2k[:, pool_fid])
                k2s = c2a[:, fid] if prev_sf is not None else None
                out, sf = self._frame(imgs[:, fid], geom, prev_sf, k2s,
                                      generator=generator)
            if key_frame:
                depth_key, height_key = out["depth"], out["height"]
            else:
                prev_sf = sf
            bev_list.append(out["bev"])
            vox_list.append(out["vox"])

        if not with_prev:
            n_prev = num_frames - (1 if cfg.stereo else 0) - 1
            bev, vox = bev_list[0], vox_list[0]
            bev_list.insert(0, bev.new_zeros(
                bev.shape[:-1] + (bev.shape[-1] * n_prev,)))
            vox_list.insert(0, vox.new_zeros(
                vox.shape[:-1] + (vox.shape[-1] * n_prev,)))

        # [history..., key]: the reference's concat order (DHD_model.py:
        # 517-518)
        if cfg.align_after_view_transformation:
            dz = vt.z_fine.size
            for i in range(len(bev_list) - 1):
                src_fid = len(bev_list) - 1 - i
                grid = shift_grid(vt.y.size, vt.x.size, s2k[:, 0, 0],
                                  s2k[:, src_fid, 0], bda, vt.x, vt.y)
                bev_list[i] = grid_sample_2d(bev_list[i], grid)
                vox_list[i] = uncollapse_z(
                    grid_sample_2d(collapse_z(vox_list[i]), grid), dz)
        return self._outputs(torch.cat(bev_list, dim=-1),
                             torch.cat(vox_list, dim=-1),
                             depth_key, height_key)
