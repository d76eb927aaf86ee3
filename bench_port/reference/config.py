"""Configuration of bench_port.reference.

A copy of the port's frozen dataclasses (the port imports nothing of the
JAX package); the dataclasses' defaults are DHD-S.  A configuration is
read from a benchmark configuration file by :func:`config_from_dict`;
the preset table is the port's alone.  Fields that only steer the JAX
package (``cv_win_rows``, ``backbone_remat``) are kept so that the files
read the same.  ``pool_method``, ``cv_method``, ``attn_method`` and
``ln_method`` are read and ignored: the reference has the plain path only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

# Occ3D-nuScenes class frequencies used for class-balanced CE weights
# (reference: projects/mmdet3d_plugin/models/dense_heads/occ_head.py:11-30).
NUSC_CLASS_FREQUENCIES = (
    944004, 1897170, 152386, 2391677, 16957802, 724139, 189027, 2074468,
    413451, 2384460, 5916653, 175883646, 4275424, 51393615, 61411620,
    105975596, 116424404, 1892500630,
)

OCC_CLASS_NAMES = (
    "others", "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
    "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
    "vegetation", "free",
)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """A 1-D regular grid: [lower, upper, interval] per axis.

    Mirrors the reference grid_config dicts (DHD-S.py:31-36).
    """
    lower: float
    upper: float
    interval: float

    @property
    def size(self) -> int:
        return int(round((self.upper - self.lower) / self.interval))


@dataclasses.dataclass(frozen=True)
class ViewTransformConfig:
    """MGHS view transformer geometry.

    Reference: projects/mmdet3d_plugin/models/necks/lss_heightmap.py:13-134 and
    projects/configs/DHD/DHD-S.py:31-105.
    """
    input_size: Tuple[int, int] = (256, 704)     # (H, W)
    downsample: int = 16
    # Frustum depth bins used to build the frustum (DHD-S: 44 bins @ 1.0 m).
    depth: GridConfig = GridConfig(1.0, 45.0, 1.0)
    # Depth binning used for the downsampled GT depth / fg-mask.  The reference
    # mutates grid_config['depth'] to 0.5 m bins inside view_transform
    # (lss_heightmap.py:425-431), so at loss time the bins are always these:
    gt_depth: GridConfig = GridConfig(1.0, 45.0, 0.5)
    # BEV xy grid (shared by all pooling passes).
    x: GridConfig = GridConfig(-40.0, 40.0, 0.4)
    y: GridConfig = GridConfig(-40.0, 40.0, 0.4)
    # z-collapsed main grid: one 6.4 m voxel over [-1, 5.4).
    z_full: GridConfig = GridConfig(-1.0, 5.4, 6.4)
    # Fine z grid: 16 voxels of 0.4 m; split into 3 height bands (slabs of
    # 4 + 4 + 8 layers) by mask_range (DHD-S.py:77-99).
    z_fine: GridConfig = GridConfig(-1.0, 5.4, 0.4)
    mask_range: Tuple[float, float, float, float] = (-1.0, 0.6, 2.2, 5.4)
    # Height distribution bins (65 bins of 0.1 m at -1.0..5.4, DHD-S.py:67-74).
    height_min: float = -1.0
    height_interval: float = 0.1
    num_height_bins: int = 65
    in_channels: int = 256
    out_channels: int = 64          # numC_Trans
    collapse_z: bool = True
    sid: bool = False

    @property
    def D(self) -> int:
        return self.depth.size

    @property
    def feat_size(self) -> Tuple[int, int]:
        return (self.input_size[0] // self.downsample,
                self.input_size[1] // self.downsample)

    @property
    def slab_sizes(self) -> Tuple[int, int, int]:
        lo, t1, t2, hi = self.mask_range
        dz = self.z_fine.interval
        return (int(round((t1 - lo) / dz)), int(round((t2 - t1) / dz)),
                int(round((hi - t2) / dz)))

    def height_bin_centers(self) -> Sequence[float]:
        return tuple(self.height_min + i * self.height_interval
                     for i in range(self.num_height_bins))


@dataclasses.dataclass(frozen=True)
class DepthNetConfig:
    """DepthNet / HeightNet topology flags.

    Reference: projects/mmdet3d_plugin/models/model_utils/depthnet.py:172-246.
    """
    use_dcn: bool = True
    use_aspp: bool = True
    aspp_mid_channels: int = -1
    # ASPP dropout rate (reference depthnet.py:115 hardcodes 0.5).  The
    # micro dryrun presets set 0.0: dropout masks are keyed by batch
    # POSITION, so the multichip dryrun's sample-permutation invariance
    # check is only meaningful on deterministic math.
    aspp_dropout: float = 0.5
    stereo: bool = False
    bias: float = 0.0


@dataclasses.dataclass(frozen=True)
class LossConfig:
    weight_ce: float = 10.0
    weight_geo: float = 0.2
    weight_sem: float = 0.2
    loss_height_weight: float = 0.1
    loss_depth_weight: float = 3.0
    class_balance: bool = True
    num_classes: int = 18
    free_class: int = 17


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """AdamW schedule (DHD-S.py:261-270)."""
    lr: float = 2e-4
    weight_decay: float = 1e-2
    grad_clip_norm: float = 5.0
    warmup_iters: int = 200
    warmup_ratio: float = 0.001
    max_epochs: int = 24
    step_epochs: Tuple[int, ...] = (24,)
    step_gamma: float = 0.1
    ema_decay: float = 0.9990
    ema_init_updates: int = 10560


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full model assembly config (one of DHD-S / DHD-M / DHD-L)."""
    name: str = "dhd_s"
    temporal: bool = False           # DHD_stereo-style temporal+stereo model
    num_adj_frames: int = 0          # history frames fused into the BEV
    stereo: bool = False
    # image backbone: 'resnet50' or 'swin_base'
    backbone: str = "resnet50"
    backbone_out_indices: Tuple[int, ...] = (2, 3)
    # Swin topology (defaults = Swin-B as in DHD-L.py:45-67)
    swin_embed_dims: int = 128
    swin_depths: Tuple[int, ...] = (2, 2, 18, 2)
    swin_num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    swin_window: int = 12
    img_neck: str = "custom_fpn"     # 'custom_fpn' | 'fpn_lss'
    img_neck_in_channels: Tuple[int, ...] = (1024, 2048)
    img_neck_out_channels: int = 256
    # view transformer
    vt: ViewTransformConfig = ViewTransformConfig()
    # MGHS depth-net flavour: 'conv1x1' (DHD-S) or 'full' (MGHS_Depth/Stereo)
    depth_net: str = "conv1x1"
    depthnet_cfg: DepthNetConfig = DepthNetConfig()
    heightnet_cfg: DepthNetConfig = DepthNetConfig()
    # BEV encoder
    bev_encoder: str = "custom_resnet"   # 'custom_resnet' | 'unet'
    bev_encoder_channels: Tuple[int, ...] = (128, 256, 512)
    bev_neck_out_channels: int = 256
    bev_unet_out: int = 512              # UNet BEV encoder output (DHD-M)
    # voxel (slab) encoders: UNet output channels per band
    voxel_encoder_out: Tuple[int, int, int] = (64, 128, 64)
    # first rung of every UNet's channel ladder (base..base*16).  The
    # reference hardcodes 64 (models/backbones/unet.py); tiny/micro test
    # presets shrink it — at 64 the three slab UNets alone hold ~1.1 GB of
    # fp32 params, which swamps any small-shape CPU run.
    unet_base: int = 64
    # pre-process nets (DHD-M/L only)
    pre_process: bool = False
    # fusion + head
    sfa_in_channels: int = 512
    sfa_out_channels: int = 256
    head_in_dim: int = 256
    head_out_dim: int = 256
    head_Dz: int = 16
    num_classes: int = 18
    use_predicter: bool = True
    loss: LossConfig = LossConfig()
    optim: OptimConfig = OptimConfig()
    num_cams: int = 6
    align_after_view_transformation: bool = False
    # rematerialize backbone blocks in backward (reference with_cp=True,
    # DHD-S.py:52)
    backbone_remat: bool = True
    # voxel pooling backend: 'xla' = the plain PyTorch pooling; anything
    # else = the CUDA kernel on the GPU
    pool_method: str = "auto"
    # stereo cost-volume backend: 'auto' = the CUDA kernel on the GPU,
    # 'xla' = the plain PyTorch version.  cv_win_rows is the JAX package's
    # Pallas row window and has no meaning here: the CUDA kernel is exact
    # for any geometry.
    cv_method: str = "auto"
    cv_win_rows: int = 2
    # Swin window-attention backend: 'xla' = the plain PyTorch composition;
    # anything else = the CUDA kernel on the GPU (ops/window_attention.py)
    attn_method: str = "auto"
    # Swin LayerNorm backend: 'xla' = the plain PyTorch one-pass LayerNorm;
    # anything else = the CUDA kernel on the GPU (ops/layer_norm.py)
    ln_method: str = "auto"

    @property
    def num_frames(self) -> int:
        """Total frames: key + adjacent + extra stereo ref frame."""
        return 1 + self.num_adj_frames + (1 if self.stereo else 0)

    @property
    def swin_out_indices(self) -> Tuple[int, ...]:
        """The Swin stages whose normed outputs feed the image neck: (2, 3)
        in a stereo model whatever ``backbone_out_indices`` lists
        (dhd_tpu/models/dhd.py:93-94)."""
        return (2, 3) if self.stereo else tuple(self.backbone_out_indices)


def class_weights(num_classes: int = 18) -> Tuple[float, ...]:
    """1/log(freq) class-balance weights (occ_head.py:74)."""
    return tuple(1.0 / math.log(f + 0.001)
                 for f in NUSC_CLASS_FREQUENCIES[:num_classes])


_NESTED = {"vt": ViewTransformConfig, "depthnet_cfg": DepthNetConfig,
           "heightnet_cfg": DepthNetConfig, "loss": LossConfig,
           "optim": OptimConfig}


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _build(cls, d: dict):
    kw = {}
    for k, v in d.items():
        if isinstance(v, dict):
            v = (GridConfig(**v) if cls is ViewTransformConfig
                 else _build(_NESTED[k], v))
        kw[k] = _tuples(v)
    return cls(**kw)


def config_from_dict(d: dict) -> ModelConfig:
    """The :class:`ModelConfig` whose ``dataclasses.asdict`` is ``d`` (lists
    read back as tuples): how the benchmark's configuration files are
    read."""
    return _build(ModelConfig, d)
