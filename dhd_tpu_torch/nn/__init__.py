from dhd_tpu_torch.nn.depthnet import DeformConv, DepthNet, HeightNet
from dhd_tpu_torch.nn.fpn import CustomFPN, FPN_LSS
from dhd_tpu_torch.nn.layers import (ASPP, BasicBlock, Bottleneck,
                                     ConvBNReLU, Mlp, SELayer,
                                     upsample_bilinear_align)
from dhd_tpu_torch.nn.occ_head import OccHead
from dhd_tpu_torch.nn.resnet import CustomResNet, ResNet50, TinyCNN
from dhd_tpu_torch.nn.sfa import SFA, ChannelSpatialStage
from dhd_tpu_torch.nn.swin import SwinTransformer
from dhd_tpu_torch.nn.unet import UNet

__all__ = [
    "ASPP", "BasicBlock", "Bottleneck", "ChannelSpatialStage", "ConvBNReLU",
    "CustomFPN", "CustomResNet", "DeformConv", "DepthNet", "FPN_LSS",
    "HeightNet", "Mlp", "OccHead", "ResNet50", "SELayer", "SFA",
    "SwinTransformer", "TinyCNN", "UNet", "upsample_bilinear_align",
]
