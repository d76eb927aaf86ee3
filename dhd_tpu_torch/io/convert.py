"""Load the JAX package's flax variables into the port.

The port's modules carry the reference's state_dict key space; this module
holds the port's own copy of the rule table that maps it onto the flax
parameter tree (the rules of ``dhd_tpu/io/convert.py`` that DHD-S, DHD-M,
DHD-L and the tiny presets reach, plus TinyCNN's) and of its layout
transforms:

* conv:       flax (kh, kw, I, O)  -> torch (O, I, kh, kw)
* conv-T:     flax (kh, kw, I, O)  -> torch (I, O, kh, kw) + spatial flip
  (lax.conv_transpose flips the kernel, torch's ConvTranspose2d does not)
* dense:      flax (I, O)          -> torch (O, I)
* 1x1 conv as dense (SE layers): flax (I, O) -> torch (O, I, 1, 1)
* BN:         params.scale/bias, batch_stats.mean/var -> weight/bias,
  running_mean/running_var
* LN:         params.scale/bias -> weight/bias
* table:      a bare parameter (the Swin relative-position bias table),
  copied as it is
* DCN weight: flax (9, Cg, G, Og)  -> torch (G*Og, Cg, 3, 3)
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from dhd_tpu_torch.config import DepthNetConfig, ModelConfig

CONV = "conv"
CONVT = "convT"
DENSE = "dense"
CONV1x1_DENSE = "conv1x1_dense"
BN = "bn"
LN = "ln"
TABLE = "table"
DCN = "dcn"

Rule = Tuple[str, Tuple[str, ...], str]      # (torch prefix, flax path, kind)


def _basicblock(tp: str, fp: Tuple[str, ...], downsample: bool) -> List[Rule]:
    rules = [(f"{tp}.conv1", fp + ("conv1",), CONV),
             (f"{tp}.bn1", fp + ("bn1",), BN),
             (f"{tp}.conv2", fp + ("conv2",), CONV),
             (f"{tp}.bn2", fp + ("bn2",), BN)]
    if downsample:
        rules.append((f"{tp}.downsample", fp + ("downsample",), CONV))
    return rules


def _bottleneck(tp: str, fp: Tuple[str, ...], downsample: bool) -> List[Rule]:
    rules = []
    for i in (1, 2, 3):
        rules += [(f"{tp}.conv{i}", fp + (f"conv{i}",), CONV),
                  (f"{tp}.bn{i}", fp + (f"bn{i}",), BN)]
    if downsample:
        rules += [(f"{tp}.downsample.0", fp + ("downsample_conv",), CONV),
                  (f"{tp}.downsample.1", fp + ("downsample_bn",), BN)]
    return rules


def _resnet50(tp: str, fp: Tuple[str, ...]) -> List[Rule]:
    rules = [(f"{tp}.conv1", fp + ("stem_conv",), CONV),
             (f"{tp}.bn1", fp + ("stem_bn",), BN)]
    for stage, n in enumerate((3, 4, 6, 3)):
        for b in range(n):
            rules += _bottleneck(f"{tp}.layer{stage + 1}.{b}",
                                 fp + (f"layer{stage + 1}_{b}",),
                                 downsample=(b == 0))
    return rules


def _tinycnn(tp: str, fp: Tuple[str, ...], n_blocks: int = 4) -> List[Rule]:
    rules = []
    for name in [f"b{i}" for i in range(n_blocks)] + ["b_last"]:
        rules += _basicblock(f"{tp}.{name}", fp + (name,), downsample=True)
    return rules


def _custom_fpn(tp: str, fp: Tuple[str, ...], n_levels: int) -> List[Rule]:
    rules = [(f"{tp}.lateral_convs.{i}.conv", fp + (f"lateral{i}",), CONV)
             for i in range(n_levels)]
    return rules + [(f"{tp}.fpn_convs.0.conv", fp + ("fpn_conv0",), CONV)]


def _fpn_lss(tp: str, fp: Tuple[str, ...], extra_upsample: bool = True
             ) -> List[Rule]:
    """FPN_LSS; the image neck (DHD-L) has no ``up2`` head."""
    rules = [(f"{tp}.conv.0", fp + ("conv_0",), CONV),
             (f"{tp}.conv.1", fp + ("conv_1",), BN),
             (f"{tp}.conv.3", fp + ("conv_3",), CONV),
             (f"{tp}.conv.4", fp + ("conv_4",), BN)]
    if extra_upsample:
        rules += [(f"{tp}.up2.1", fp + ("up2_1",), CONV),
                  (f"{tp}.up2.2", fp + ("up2_2",), BN),
                  (f"{tp}.up2.4", fp + ("up2_4",), CONV)]
    return rules


def _swin_block(tp: str, fp: Tuple[str, ...]) -> List[Rule]:
    return [(f"{tp}.norm1", fp + ("norm1",), LN),
            (f"{tp}.attn.w_msa.relative_position_bias_table",
             fp + ("attn", "relative_position_bias_table"), TABLE),
            (f"{tp}.attn.w_msa.qkv", fp + ("attn", "qkv"), DENSE),
            (f"{tp}.attn.w_msa.proj", fp + ("attn", "proj"), DENSE),
            (f"{tp}.norm2", fp + ("norm2",), LN),
            (f"{tp}.ffn.layers.0.0", fp + ("fc1",), DENSE),
            (f"{tp}.ffn.layers.1", fp + ("fc2",), DENSE)]


def _swin(tp: str, fp: Tuple[str, ...], depths: Tuple[int, ...],
          out_indices: Tuple[int, ...]) -> List[Rule]:
    """Swin (mmcv naming, models/backbones/swin.py:680-976)."""
    rules = [(f"{tp}.patch_embed.projection", fp + ("patch_embed",), CONV),
             (f"{tp}.patch_embed.norm", fp + ("patch_norm",), LN)]
    for i, depth in enumerate(depths):
        for j in range(depth):
            rules += _swin_block(f"{tp}.stages.{i}.blocks.{j}",
                                 fp + (f"stage{i}_block{j}",))
        if i < len(depths) - 1:
            rules += [(f"{tp}.stages.{i}.downsample.norm",
                       fp + (f"downsample{i}", "norm"), LN),
                      (f"{tp}.stages.{i}.downsample.reduction",
                       fp + (f"downsample{i}", "reduction"), DENSE)]
        if i in out_indices:
            rules.append((f"{tp}.norm{i}", fp + (f"norm{i}",), LN))
    return rules


def _aspp(tp: str, fp: Tuple[str, ...]) -> List[Rule]:
    rules = []
    for i in range(1, 5):
        rules += [(f"{tp}.aspp{i}.atrous_conv", fp + (f"aspp{i}", "conv"),
                   CONV),
                  (f"{tp}.aspp{i}.bn", fp + (f"aspp{i}", "bn"), BN)]
    return rules + [(f"{tp}.global_avg_pool.1", fp + ("gap", "conv"), CONV),
                    (f"{tp}.global_avg_pool.2", fp + ("gap", "bn"), BN),
                    (f"{tp}.conv1", fp + ("conv1",), CONV),
                    (f"{tp}.bn1", fp + ("bn1",), BN)]


def _distribution_net(tp: str, fp: Tuple[str, ...], cfg: DepthNetConfig
                      ) -> List[Rule]:
    """The depth_conv Sequential of DepthNet/HeightNet, and in a stereo net
    the cost_volumn_net (the reference's spelling) beside it; indices shift
    with the aspp/dcn flags (depthnet.py:216-244)."""
    rules = []
    if cfg.stereo:
        for i in range(2):
            rules += [(f"{tp}.cost_volumn_net.{2 * i}", fp + (f"cv_conv{i}",),
                       CONV),
                      (f"{tp}.cost_volumn_net.{2 * i + 1}",
                       fp + (f"cv_bn{i}",), BN)]
    for i in range(3):
        rules += _basicblock(f"{tp}.depth_conv.{i}", fp + (f"block{i}",),
                             downsample=cfg.stereo and i == 0)
    idx = 3
    if cfg.use_aspp:
        rules += _aspp(f"{tp}.depth_conv.{idx}", fp + ("aspp",))
        idx += 1
    if cfg.use_dcn:
        rules += [(f"{tp}.depth_conv.{idx}.conv_offset",
                   fp + ("dcn", "conv_offset"), CONV),
                  (f"{tp}.depth_conv.{idx}", fp + ("dcn",), DCN)]
        idx += 1
    return rules + [(f"{tp}.depth_conv.{idx}", fp + ("out_conv",), CONV)]


def _heightnet(tp: str, fp: Tuple[str, ...], cfg: DepthNetConfig
               ) -> List[Rule]:
    rules = [
        (f"{tp}.reduce_conv.0", fp + ("reduce_conv",), CONV),
        (f"{tp}.reduce_conv.1", fp + ("reduce_bn",), BN),
        (f"{tp}.bn", fp + ("mlp_bn",), BN),
        (f"{tp}.depth_mlp.fc1", fp + ("depth_mlp", "fc1"), DENSE),
        (f"{tp}.depth_mlp.fc2", fp + ("depth_mlp", "fc2"), DENSE),
        (f"{tp}.depth_se.conv_reduce", fp + ("depth_se", "conv_reduce"),
         CONV1x1_DENSE),
        (f"{tp}.depth_se.conv_expand", fp + ("depth_se", "conv_expand"),
         CONV1x1_DENSE),
    ]
    return rules + _distribution_net(tp, fp + ("depth_conv",), cfg)


def _depthnet_full(tp: str, fp: Tuple[str, ...], cfg: DepthNetConfig
                   ) -> List[Rule]:
    """DepthNet: HeightNet's rules plus the context branch."""
    return _heightnet(tp, fp, cfg) + [
        (f"{tp}.context_conv", fp + ("context_conv",), CONV),
        (f"{tp}.context_mlp.fc1", fp + ("context_mlp", "fc1"), DENSE),
        (f"{tp}.context_mlp.fc2", fp + ("context_mlp", "fc2"), DENSE),
        (f"{tp}.context_se.conv_reduce",
         fp + ("context_se", "conv_reduce"), CONV1x1_DENSE),
        (f"{tp}.context_se.conv_expand",
         fp + ("context_se", "conv_expand"), CONV1x1_DENSE),
    ]


def _custom_resnet(tp: str, fp: Tuple[str, ...], n_stages: int
                   ) -> List[Rule]:
    rules = []
    for i in range(n_stages):
        for j in range(2):
            rules += _basicblock(f"{tp}.layers.{i}.{j}",
                                 fp + (f"stage{i}_{j}",), downsample=(j == 0))
    return rules


def _double_conv(tp: str, fp: Tuple[str, ...]) -> List[Rule]:
    return [(f"{tp}.0", fp + ("conv0",), CONV),
            (f"{tp}.1", fp + ("bn0",), BN),
            (f"{tp}.3", fp + ("conv1",), CONV),
            (f"{tp}.4", fp + ("bn1",), BN)]


def _unet(tp: str, fp: Tuple[str, ...]) -> List[Rule]:
    rules = _double_conv(f"{tp}.inc.double_conv", fp + ("inc",))
    for j in range(1, 5):
        rules += _double_conv(f"{tp}.down{j}.maxpool_conv.1.double_conv",
                              fp + (f"down{j}",))
    for j in range(1, 5):
        rules.append((f"{tp}.up{j}.up", fp + (f"up{j}", "up"), CONVT))
        rules += _double_conv(f"{tp}.up{j}.conv.double_conv",
                              fp + (f"up{j}", "conv"))
    return rules + [(f"{tp}.outc.conv", fp + ("outc",), CONV)]


def _sfa(tp: str, fp: Tuple[str, ...]) -> List[Rule]:
    st, fs = f"{tp}.mysk_7", fp + ("stage",)
    return [
        (f"{st}.fc.0", fs + ("fc0",), DENSE),
        (f"{st}.fc.2", fs + ("fc1",), DENSE),
        (f"{st}.spacial_leanring.0", fs + ("sp0",), CONV),
        (f"{st}.spacial_leanring.1", fs + ("sp_bn0",), BN),
        (f"{st}.spacial_leanring.3", fs + ("sp1",), CONV),
        (f"{st}.spacial_leanring.4", fs + ("sp_bn1",), BN),
        (f"{tp}.mix_residual.0", fp + ("res0",), CONV),
        (f"{tp}.mix_residual.1", fp + ("res_bn0",), BN),
        (f"{tp}.mix_residual.3", fp + ("res1",), CONV),
        (f"{tp}.mix_residual.4", fp + ("res_bn1",), BN),
        (f"{tp}.mix_shortcut.0", fp + ("shortcut",), CONV),
        (f"{tp}.mix_shortcut.1", fp + ("sc_bn",), BN),
    ]


def _occ_head(tp: str, fp: Tuple[str, ...], use_predicter: bool
              ) -> List[Rule]:
    rules = [(f"{tp}.final_conv.conv", fp + ("final_conv",), CONV)]
    if use_predicter:
        rules += [(f"{tp}.predicter.0", fp + ("fc0",), DENSE),
                  (f"{tp}.predicter.2", fp + ("fc1",), DENSE)]
    return rules


def build_rules(cfg: ModelConfig) -> List[Rule]:
    """Rule table of the DHD model (single-frame or temporal) of a
    preset."""
    if cfg.backbone == "resnet50":
        rules = _resnet50("img_backbone", ("img_encoder", "backbone"))
    elif cfg.backbone == "tiny_cnn":
        rules = _tinycnn("img_backbone", ("img_encoder", "backbone"))
    elif cfg.backbone == "swin_base":
        rules = _swin("img_backbone", ("img_encoder", "backbone"),
                      cfg.swin_depths, cfg.swin_out_indices)
    else:
        raise NotImplementedError(cfg.backbone)
    if cfg.img_neck == "custom_fpn":
        rules += _custom_fpn("img_neck", ("img_encoder", "neck"),
                             len(cfg.img_neck_in_channels))
    elif cfg.img_neck == "fpn_lss":
        rules += _fpn_lss("img_neck", ("img_encoder", "neck"),
                          extra_upsample=False)
    else:
        raise NotImplementedError(cfg.img_neck)
    if cfg.depth_net == "conv1x1":
        rules.append(("img_view_transformer.depth_net", ("vt", "depth_net"),
                      CONV))
    else:
        rules += _depthnet_full("img_view_transformer.depth_net",
                                ("vt", "depth_net"), cfg.depthnet_cfg)
    rules += _heightnet("img_view_transformer.height_net",
                        ("vt", "height_net"), cfg.heightnet_cfg)
    if cfg.bev_encoder == "custom_resnet":
        rules += _custom_resnet("img_bev_encoder_backbone",
                                ("bev_encoder", "backbone"),
                                len(cfg.bev_encoder_channels))
        rules += _fpn_lss("img_bev_encoder_neck", ("bev_encoder", "neck"),
                          extra_upsample=True)
    else:
        rules += _unet("img_bev_encoder_backbone",
                       ("bev_encoder", "backbone"))
    for k in range(3):
        rules += _unet(f"img_voxel_encoder{k}", (f"voxel_encoder{k}",))
    rules += _sfa("mix", ("sfa",))
    rules += _occ_head("occ_head", ("occ_head",), cfg.use_predicter)
    if cfg.pre_process:
        for tp, fp in (("pre_process_net", "pre_process"),
                       ("pre_process_net_3d", "pre_process_3d")):
            rules += _basicblock(f"{tp}.layers.0.0", (fp, "stage0_0"),
                                 downsample=True)
    return rules


def _node(tree: Dict[str, Any], path: Tuple[str, ...]) -> Dict[str, Any]:
    for p in path:
        tree = tree[p]
    return tree


def variables_to_state_dict(variables: Dict[str, Any], rules: List[Rule]
                            ) -> Dict[str, np.ndarray]:
    """Flax variables (nested dicts of arrays) -> reference-keyed numpy
    state_dict.  Raises if a flax parameter is left unmapped."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    used = set()
    for tp, fp, kind in rules:
        if kind == TABLE:
            sd[tp] = np.asarray(_node(params, fp[:-1])[fp[-1]])
            used.add((fp[:-1], fp[-1]))
            continue
        node = _node(params, fp)
        used.update((fp, k) for k in node)
        if kind == LN:
            sd[f"{tp}.weight"] = np.asarray(node["scale"])
            sd[f"{tp}.bias"] = np.asarray(node["bias"])
            continue
        if kind == BN:
            st = _node(stats, fp)
            sd[f"{tp}.weight"] = np.asarray(node["scale"])
            sd[f"{tp}.bias"] = np.asarray(node["bias"])
            sd[f"{tp}.running_mean"] = np.asarray(st["mean"])
            sd[f"{tp}.running_var"] = np.asarray(st["var"])
            sd[f"{tp}.num_batches_tracked"] = np.zeros((), np.int64)
            continue
        w = np.asarray(node["kernel"])
        if kind == CONV:
            w = w.transpose(3, 2, 0, 1)
        elif kind == CONVT:
            w = w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        elif kind == DENSE:
            w = w.T
        elif kind == CONV1x1_DENSE:
            w = w.T[:, :, None, None]
        elif kind == DCN:
            k, cg, g, og = w.shape
            w = w.transpose(2, 3, 1, 0).reshape(g * og, cg, 3, 3)
        else:
            raise ValueError(kind)
        sd[f"{tp}.weight"] = np.ascontiguousarray(w)
        if "bias" in node:
            sd[f"{tp}.bias"] = np.asarray(node["bias"])

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                yield from leaves(v, path + (k,))
            else:
                yield path, k
    unmapped = [p for p in leaves(params) if p not in used]
    if unmapped:
        raise KeyError(f"flax parameters without a rule: {unmapped[:8]}")
    return sd


def load_jax_variables(model: nn.Module, variables: Dict[str, Any],
                       cfg: ModelConfig) -> None:
    """Load the JAX package's ``DHDNet`` or ``DHDStereoNet`` variables (a
    nested dict of numpy arrays) into the port's model of the same preset
    with ``strict=True``, keeping each tensor's device and dtype."""
    ref = model.state_dict()
    sd = variables_to_state_dict(variables, build_rules(cfg))
    model.load_state_dict(
        {k: torch.tensor(v, device=ref[k].device if k in ref else None,
                         dtype=ref[k].dtype if k in ref else None)
         for k, v in sd.items()}, strict=True)
