"""DHD model assembly (single-frame DHD-S path, and the modules the
temporal model shares): counterpart of ``dhd_tpu/models/dhd.py``.

  image encoder (ResNet50+CustomFPN, or Swin-B+FPN_LSS for DHD-L)
  ->  depth-net (1x1 or full) + HeightNet
  -> fused MGHS voxel pooling   ->  BEV encoder || 3 slab UNets
  -> SFA fusion                 ->  channel-to-height occupancy head

Modules run in NCHW; the public functions keep the JAX package's layouts
(images (B, N, H, W, 3) in, occupancy logits (B, Dx, Dy, Dz, n_cls) out).
Module attributes follow the reference's state_dict key space
(``img_backbone.*``, ``img_neck.*``, ``img_view_transformer.*``,
``img_bev_encoder_{backbone,neck}.*``, ``img_voxel_encoder{0,1,2}.*``,
``mix.*``, ``occ_head.*``, and in temporal models
``pre_process_net{,_3d}.*``).
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from dhd_tpu_torch import profiling
from dhd_tpu_torch.config import ModelConfig, ViewTransformConfig
from dhd_tpu_torch.device import device_constant, resolve_device
from dhd_tpu_torch.geometry import (create_frustum, frustum_to_ego,
                                    get_mlp_input)
from dhd_tpu_torch.nn import (SFA, CustomFPN, CustomResNet, DeformConv,
                              DepthNet, FPN_LSS, HeightNet, OccHead, ResNet50,
                              SwinTransformer, TinyCNN, UNet)
from dhd_tpu_torch.nn.layers import Conv2d
from dhd_tpu_torch.nn.swin import WindowMSA
from dhd_tpu_torch.ops import (PoolIndices, PoolPlan, build_pool_plan,
                               compute_pool_indices, mghs_pool,
                               mghs_pool_cuda)

from . import graphs

GEOM_KEYS = ("sensor2keyego", "intrins", "post_rots", "post_trans", "bda")


def build_image_backbone(cfg: ModelConfig) -> nn.Module:
    """The image backbone of ``cfg``; a stereo one lists its stride-4
    feature first in ``out_channels``."""
    if cfg.backbone == "resnet50":
        return ResNet50(cfg.backbone_out_indices, remat=cfg.backbone_remat)
    if cfg.backbone == "tiny_cnn":
        return TinyCNN(emit_stereo=cfg.stereo)
    if cfg.backbone == "swin_base":
        # a stereo Swin emits stages 2 and 3 whatever the preset lists
        # (dhd_tpu/models/dhd.py:93-94); "xla" selects the plain
        # attention / LayerNorm, anything else kernels B4 / B5
        return SwinTransformer(
            cfg.swin_embed_dims, cfg.swin_depths, cfg.swin_num_heads,
            cfg.swin_window, cfg.swin_out_indices,
            return_stereo_feat=cfg.stereo,
            attn_kernel=cfg.attn_method != "xla",
            ln_kernel=cfg.ln_method != "xla", remat=cfg.backbone_remat)
    raise NotImplementedError(cfg.backbone)


def stereo_feat_channels(cfg: ModelConfig) -> int:
    """Channels of the stride-4 feature a stereo backbone emits, without
    building it: ResNet-50 layer1, TinyCNN's second block or Swin stage 0."""
    return {"resnet50": 256, "tiny_cnn": 32,
            "swin_base": cfg.swin_embed_dims}[cfg.backbone]


def band_masks_from_height(height_prob: torch.Tensor,
                           vt: ViewTransformConfig) -> torch.Tensor:
    """Per-pixel height-band gates from the height distribution.

    argmax bin -> height in meters (bin centres) -> one of the 3 bands
    [h_min, thr1), [thr1, thr2), [thr2, h_max) (lss_heightmap.py:528-564).
    The top bin centre equals h_max and is in no band, as in the reference.

    Args:
      height_prob: (..., H) softmaxed height distribution.
    Returns:
      (..., 3) mask in height_prob.dtype.
    """
    centers = device_constant(vt.height_bin_centers(), height_prob.device)
    hmap = centers[height_prob.argmax(dim=-1)]
    lo, t1, t2, hi = vt.mask_range
    return torch.stack([(hmap >= lo) & (hmap < t1),
                        (hmap >= t1) & (hmap < t2),
                        (hmap >= t2) & (hmap < hi)],
                       dim=-1).to(height_prob.dtype)


def collapse_z(x: torch.Tensor) -> torch.Tensor:
    """(B, Dy, Dx, Dz, C) -> (B, Dy, Dx, Dz*C), z-major channel order,
    matching torch.cat(x.unbind(dim=2), 1) on the reference's
    (B, C, Dz, Dy, Dx) (lss_heightmap.py:297-299)."""
    b, dy, dx, dz, c = x.shape
    return x.reshape(b, dy, dx, dz * c)


@functools.lru_cache(maxsize=None)
def _frustum(vt: ViewTransformConfig, device: torch.device) -> torch.Tensor:
    """The pooling frustum of ``vt`` on ``device``, copied from the host
    once: a frame planned in the call (every training step) does not wait
    for the copy.  Callers must not modify it in place."""
    return create_frustum(vt.depth, vt.input_size, vt.downsample, vt.sid,
                          device=device)


def _pool_indices(cfg: ModelConfig, geom: Dict[str, torch.Tensor]
                  ) -> PoolIndices:
    vt = cfg.vt
    frustum = _frustum(vt, geom["bda"].device)
    coords = frustum_to_ego(frustum, *(geom[k] for k in GEOM_KEYS))
    return compute_pool_indices(coords, vt)


def _as_tensor(x: Any, device: torch.device,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device, dtype=dtype)


def build_batch_pool_plan(cfg: ModelConfig, batch: Dict[str, Any],
                          device: Optional[Union[str, torch.device]] = None
                          ) -> PoolPlan:
    """The pooling plan of a fixed-geometry batch.

    The serving counterpart of the reference's 'accelerate' mode
    (tools/analysis_tools/benchmark.py:83-84): geometry depends only on
    calibration and augmentation, so a fixed camera rig computes this once
    and passes it as ``batch["pool_plan"]`` with every frame.
    """
    device = resolve_device(device)
    with profiling.span("setup.pool_plan", always=True):
        geom = {k: _as_tensor(batch[k], device, torch.float32)
                for k in GEOM_KEYS}
        vt = cfg.vt
        b, n = geom["sensor2keyego"].shape[:2]
        fh, fw = vt.feat_size
        return build_pool_plan(_pool_indices(cfg, geom), vt,
                               (b, n, vt.D, fh, fw), fit_scratch=True)


class MGHSTransform(nn.Module):
    """MGHS view transformer (lss_heightmap.py:13-490): the depth net (the
    1x1 conv of DHD-S or the full, optionally stereo, DepthNet), HeightNet,
    and the fused voxel pooling."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        vt = cfg.vt
        if cfg.depth_net == "conv1x1":
            self.depth_net = Conv2d(vt.in_channels,
                                       vt.D + vt.out_channels, 1)
        elif cfg.depth_net == "full":
            self.depth_net = DepthNet(vt.in_channels, vt.in_channels,
                                      vt.out_channels, vt.D, cfg.depthnet_cfg)
        else:
            raise NotImplementedError(cfg.depth_net)
        self.height_net = HeightNet(vt.in_channels, vt.in_channels,
                                    vt.num_height_bins, cfg.heightnet_cfg)

    def forward(self, x: torch.Tensor, geom: Dict[str, torch.Tensor],
                plan: Optional[PoolPlan] = None,
                cost_volume: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """
        Args:
          x: (B, N, C_in, fH, fW) image features.
          geom: sensor2keyego / intrins / post_rots / post_trans / bda, and
            optionally mlp_sensor2keyego (the key frame's, for the camera
            embedding of a history frame).
          plan: optional cached pooling plan.
          cost_volume: (B*N, D, 4fH, 4fW) stereo depth probabilities, for a
            stereo depth net.
          generator: draws the ASPP dropout masks in training.
        Returns:
          bev (B, Dy, Dx, C), vox (B, Dy, Dx, Dz, C) and the fp32 softmax
          distributions depth (B, N, fH, fW, D), height (B, N, fH, fW, H).
        """
        vt = self.cfg.vt
        b, n, c_in, fh, fw = x.shape
        x = x.reshape(b * n, c_in, fh, fw)
        mlp_input = get_mlp_input(
            geom.get("mlp_sensor2keyego", geom["sensor2keyego"]),
            *(geom[k] for k in GEOM_KEYS[1:])).reshape(b * n, 27)
        if self.cfg.depth_net == "conv1x1":
            # one 1x1 conv emits depth logits + context features
            # (lss_heightmap.py:62,482-485)
            xd = self.depth_net(x)
        else:
            xd = self.depth_net(x, mlp_input, cost_volume, generator)
        xd = xd.permute(0, 2, 3, 1)                     # (BN, fH, fW, D+C)
        depth = torch.softmax(xd[..., :vt.D].float(), dim=-1)
        feat = xd[..., vt.D:vt.D + vt.out_channels].contiguous()
        height_logit = self.height_net(x, mlp_input, generator=generator)
        height = torch.softmax(height_logit.float(), dim=1).permute(0, 2, 3, 1)
        band_mask = band_masks_from_height(height, vt).to(x.dtype)

        px = (b, n, fh, fw)
        feat = feat.reshape(px + (vt.out_channels,))
        band_mask = band_mask.reshape(px + (3,))
        use_kernel = self.cfg.pool_method != "xla" and (
            plan is not None or x.is_cuda)
        if use_kernel:
            # the kernel path; without a cached plan, plan this frame (a
            # training frame has its own geometry).  Under autograd B1
            # runs in its autograd.Function
            if plan is None:
                plan = build_pool_plan(_pool_indices(self.cfg, geom), vt,
                                       (b, n, vt.D, fh, fw))
            bev, vox = mghs_pool_cuda(
                depth.to(x.dtype).contiguous().reshape(px + (vt.D,)), feat,
                band_mask, plan)
        else:
            depth_p = depth.reshape(px + (vt.D,)).permute(0, 1, 4, 2, 3)
            bev, vox = mghs_pool(depth_p.to(x.dtype), feat, band_mask,
                                 _pool_indices(self.cfg, geom), vt)
        return {"bev": bev, "vox": vox,
                "depth": depth.reshape(px + (vt.D,)),
                "height": height.reshape(px + (vt.num_height_bins,))}


def _normal_(w: torch.Tensor, fan_in: int, gain: float,
             generator: torch.Generator) -> None:
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator)
                * math.sqrt(gain / fan_in))


def _trunc_normal_(w: torch.Tensor, std: float,
                   generator: torch.Generator) -> None:
    """flax ``truncated_normal(std)``: a standard normal cut at ±2, scaled
    to standard deviation ``std`` (by inverting the normal CDF)."""
    cdf = [0.5 * (1 + math.erf(z / math.sqrt(2))) for z in (-2.0, 2.0)]
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    z = torch.erfinv(2 * (cdf[0] + u * (cdf[1] - cdf[0])) - 1) * math.sqrt(2)
    with torch.no_grad():
        w.copy_(z * (std / 0.87962566103423978))


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights at the scales of the JAX package's flax
    initialisers: LeCun-normal convs and dense layers (flax's default),
    He-normal DCN kernels, zero biases, identity BatchNorm (running mean 0,
    var 1), Swin bias tables truncated-normal(0.02)
    (dhd_tpu/nn/swin.py:168-171); LayerNorms keep the weight 1 and bias 0
    they are built with.  The DCN offset convs stay zero, as the
    reference initialises them.  (He-normal everywhere makes the BN-less
    random DHD-S chaotic: one bf16 ulp in the pooled grid then moves ~1% of
    the argmaxes.)"""
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            if name.endswith("conv_offset"):
                continue
            w = mod.weight
            fan_in = (w.shape[0] * w[0, 0].numel()
                      if isinstance(mod, nn.ConvTranspose2d)
                      else w[0].numel())
            _normal_(w, fan_in, 1.0, generator)
            if mod.bias is not None:
                with torch.no_grad():
                    mod.bias.zero_()
        elif isinstance(mod, DeformConv):
            # flax counts the (9, Cg, G, Og) kernel's fan-in as 9*Cg*G
            _normal_(mod.weight, mod.weight[0].numel() * mod.groups, 2.0,
                     generator)
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.reset_parameters()
        elif isinstance(mod, WindowMSA):
            _trunc_normal_(mod.relative_position_bias_table, 0.02, generator)


class DHDNet(nn.Module):
    """Single-frame DHD (DHD-S).

    ``DHDNet(cfg, dtype, device, generator)`` builds the model with seeded
    random weights (load real ones with
    :func:`dhd_tpu_torch.io.load_jax_variables` or ``load_state_dict``) in
    eval mode on ``device`` (default: the GPU; raises if there is none).
    Every BatchNorm keeps its affine and statistics in fp32 in a bf16 model
    (and the camera embedding's normalises in fp32), as the JAX package's.

    In eval mode a call records no autograd graph, whatever the grad mode
    (serving).  After ``model.train()`` a grad-enabled call is the training
    forward of the JAX package's ``train=True``: gradients flow, BatchNorms
    use batch statistics and step their running ones, the ASPP dropout and
    the Swin's DropPath draw from the call's ``generator``, and the image
    backbone recomputes its blocks in the backward where
    ``cfg.backbone_remat`` says so.

    The forward computes in :attr:`dtype`: the weights' own, or inside
    :meth:`computing_in` another (bf16 mixed-precision training).

    A frame served in eval mode on the card with the rig's cached plans
    replays CUDA graphs of its modules after two frames
    (:mod:`dhd_tpu_torch.models.graphs`); its outputs are the caller's.
    """
    temporal = False
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.temporal != self.temporal:
            raise ValueError(
                f"{cfg.name} is {'a' if cfg.temporal else 'not a'} temporal "
                f"preset: build it with "
                f"{'DHDStereoNet' if cfg.temporal else 'DHDNet'}")
        device = resolve_device(device)
        self.cfg = cfg
        vt = cfg.vt
        # image encoder (the JAX ImageEncoder): backbone + neck; a stereo
        # backbone also emits its stride-4 feature, which skips the neck
        self.img_backbone = build_image_backbone(cfg)
        neck_in = self.img_backbone.out_channels[1 if cfg.stereo else 0:]
        if cfg.img_neck == "custom_fpn":
            self.img_neck = CustomFPN(neck_in, cfg.img_neck_out_channels)
        elif cfg.img_neck == "fpn_lss":
            self.img_neck = FPN_LSS(sum(neck_in), cfg.img_neck_out_channels,
                                    scale_factor=2, input_feature_index=(0, 1),
                                    extra_upsample=None)
        else:
            raise NotImplementedError(cfg.img_neck)
        self.img_view_transformer = MGHSTransform(cfg)
        # BEV encoder (the JAX BEVEncoder) over the grids of every fused
        # frame (key + history), concatenated on channels
        n_fused = cfg.num_frames - (1 if cfg.stereo else 0)
        c_bev = vt.out_channels * n_fused
        if cfg.bev_encoder == "custom_resnet":
            ch = cfg.bev_encoder_channels
            self.img_bev_encoder_backbone = CustomResNet(c_bev, ch)
            self.img_bev_encoder_neck = FPN_LSS(ch[-1] + ch[0],
                                                cfg.bev_neck_out_channels)
        elif cfg.bev_encoder == "unet":
            # UNet + Identity neck (DHD-M)
            self.img_bev_encoder_backbone = UNet(c_bev, cfg.bev_unet_out,
                                                 base=cfg.unet_base)
        else:
            raise NotImplementedError(cfg.bev_encoder)
        for k, slab in enumerate(vt.slab_sizes):
            self.add_module(f"img_voxel_encoder{k}",
                            UNet(slab * c_bev, cfg.voxel_encoder_out[k],
                                 base=cfg.unet_base))
        # the fused width that reaches SFA, as flax infers it: the config's
        # sfa_in_channels is unused by the JAX package and disagrees with it
        # in dhd_tiny_stereo (192 against 128)
        c_2d = (cfg.bev_neck_out_channels if cfg.bev_encoder == "custom_resnet"
                else cfg.bev_unet_out)
        self.mix = SFA(c_2d + sum(cfg.voxel_encoder_out), cfg.sfa_out_channels)
        self.occ_head = OccHead(cfg.head_in_dim, cfg.head_out_dim,
                                cfg.head_Dz, cfg.num_classes,
                                cfg.use_predicter, return_flat=True)
        if cfg.pre_process:
            # one-block CustomResNets over each frame's grids
            # (DHD_model.py:360-368)
            c, cz = vt.out_channels, vt.out_channels * vt.z_fine.size
            self.pre_process_net = CustomResNet(c, (c,), (1,), (1,))
            self.pre_process_net_3d = CustomResNet(cz, (cz,), (1,), (1,))
        with profiling.span("setup.init_weights", always=True):
            init_weights(self, generator if generator is not None
                         else torch.Generator().manual_seed(0))
        self._graphs = graphs.FrameGraphs()
        self.register_load_state_dict_post_hook(DHDNet._weights_loaded)
        self.eval()
        self.to(device=device, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.occ_head.final_conv.conv.weight.device

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the forward computes in (the images' and, with them,
        every layer's): the weights' own unless :meth:`computing_in` says
        otherwise."""
        return (self.compute_dtype
                or self.occ_head.final_conv.conv.weight.dtype)

    @contextlib.contextmanager
    def computing_in(self, dtype: Optional[torch.dtype]):
        """Inside, the forward computes in ``dtype`` (None: the weights'
        dtype) over the weights as they are: the JAX package's
        ``build_model(cfg, dtype=bf16)`` over fp32 params.  Each conv and
        dense layer casts its weights to its input's dtype
        (``nn/layers.py:Conv2d``); the softmaxes, the Layer- and
        BatchNorm statistics, the camera-embedding BatchNorm, the pooled
        sums and ``occ_logits`` stay fp32, as there.  The gradients reach
        fp32 weights in fp32."""
        saved = self.compute_dtype
        self.compute_dtype = dtype
        try:
            yield self
        finally:
            self.compute_dtype = saved

    def _weights_loaded(self, incompatible_keys) -> None:
        """``load_state_dict``'s hook: the served frame captures anew."""
        self._graphs.invalidate()

    def _served(self, call: str, batch: Dict[str, Any],
                cache: Optional[Dict[str, torch.Tensor]] = None):
        """The frame of a call (``"frame"``, ``"stream"``): from CUDA
        graphs where :func:`graphs.engages`, eager otherwise.  The rig's
        plans count where the served path reads them: the pooling kernel's
        ``pool_plan``, and a stereo model's ``cv_static`` for B3."""
        cfg = self.cfg
        rig = () if cfg.pool_method == "xla" else ("pool_plan",)
        if cfg.stereo:
            rig = () if cfg.cv_method == "xla" else rig + ("cv_static",)
        engaged = graphs.engages(
            call, training=self.training,
            grad_enabled=torch.is_grad_enabled(), device=self.device,
            compiling=graphs.compiling(), batch=batch, rig=rig, cache=cache)
        return self._graphs.frame(engaged, batch, rig, cache, self.device,
                                  self.dtype)

    def _geom(self, batch: Dict[str, Any], keys=GEOM_KEYS
              ) -> Dict[str, torch.Tensor]:
        return {k: _as_tensor(batch[k], self.device, torch.float32)
                for k in keys}

    def _encode(self, imgs: torch.Tensor, stage0_only: bool = False,
                generator: Optional[torch.Generator] = None):
        """Image encoder over (B*N, 3, H, W) images: the neck's features
        and, for a stereo model, the stride-4 stereo feature (the only
        output with ``stage0_only``).  ``generator`` draws the Swin's
        DropPath masks in training."""
        with profiling.span("encode"):
            feats = self._unit("img_backbone", imgs, stage0_only=stage0_only,
                               generator=generator)
            if stage0_only:
                return None, feats
            stereo_feat = None
            if self.cfg.stereo:
                stereo_feat, feats = feats[0], feats[1:]
            return self._unit("img_neck", feats), stereo_feat

    def _fuse_and_predict(self, bev: torch.Tensor, vox: torch.Tensor):
        """BEV encoder || slab UNets -> SFA -> occupancy head.

        bev (B, Dy, Dx, C'), vox (B, Dy, Dx, Dz, C') ->
        occ_logits (B, Dx, Dy, Dz, n_cls) and the packed
        (B, Dx, Dy, Dz*n_cls), fp32."""
        with profiling.span("head"):
            cfg = self.cfg
            unit = self._unit
            with profiling.span("bev_encoder"):
                x_2d = unit("img_bev_encoder_backbone",
                            bev.permute(0, 3, 1, 2))
                if cfg.bev_encoder == "custom_resnet":
                    x_2d = unit("img_bev_encoder_neck", x_2d)
            with profiling.span("voxel_encoders"):
                s1, s2, _ = cfg.vt.slab_sizes          # vox z-minor
                slabs = (vox[..., :s1, :], vox[..., s1:s1 + s2, :],
                         vox[..., s1 + s2:, :])
                x_3d = torch.cat([
                    unit(f"img_voxel_encoder{k}",
                         collapse_z(slab).permute(0, 3, 1, 2))
                    for k, slab in enumerate(slabs)], dim=1)
            with profiling.span("fuse"):
                fused = unit("mix", torch.cat([x_2d, x_3d], dim=1))
                # (B, Dx, Dy, Dz*n_cls), the caller's
                occ = self._graphs.own(unit("occ_head", fused).float())
            return (occ.reshape(occ.shape[:3]
                                + (cfg.head_Dz, cfg.num_classes)), occ)

    def _unit(self, name: str, *args, **kwargs):
        """The child module ``name`` called as a unit of the frame's
        graphs."""
        return self._graphs.call(name, getattr(self, name), *args, **kwargs)

    def forward(self, batch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Forward pass (the class docstring says what train mode changes).

        Args:
          batch: numpy arrays or tensors: imgs (B, N, H, W, 3) normalized
            images; sensor2keyego (B, N, 4, 4); intrins, post_rots
            (B, N, 3, 3); post_trans (B, N, 3); bda (B, 3, 3); optional
            pool_plan from :func:`build_batch_pool_plan`.  Other keys (the
            ground truth) are ignored.
          generator: draws the dropout masks in training, on the model's
            device.
        Returns:
          occ_logits (B, Dx, Dy, Dz, n_cls), occ_logits_flat
          (B, Dx, Dy, Dz*n_cls), depth and height distributions; fp32.
        """
        with profiling.span("forward"), torch.set_grad_enabled(
                self.training and torch.is_grad_enabled()), \
                self._served("frame", batch):
            return self._single_frame(batch, generator)

    def _single_frame(self, batch, generator):
        imgs = _as_tensor(batch["imgs"], self.device, self.dtype)
        b, n, h, w, _ = imgs.shape
        x, _ = self._encode(
            imgs.permute(0, 1, 4, 2, 3).reshape(b * n, 3, h, w),
            generator=generator)
        x = x.reshape((b, n) + x.shape[1:])
        with profiling.span("view_transform"):
            vt_out = self._unit("img_view_transformer", x, self._geom(batch),
                                batch.get("pool_plan"), generator=generator)
        occ, occ_flat = self._fuse_and_predict(vt_out["bev"], vt_out["vox"])
        return {"occ_logits": occ, "occ_logits_flat": occ_flat,
                "depth": self._graphs.own(vt_out["depth"]),
                "height": self._graphs.own(vt_out["height"])}
