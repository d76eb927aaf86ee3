from bench_port.reference.nn.depthnet import DeformConv, DepthNet, HeightNet
from bench_port.reference.nn.fpn import CustomFPN, FPN_LSS
from bench_port.reference.nn.layers import (ASPP, BasicBlock, Bottleneck,
                                            ConvBNReLU, Mlp, SELayer,
                                            upsample_bilinear_align)
from bench_port.reference.nn.occ_head import OccHead
from bench_port.reference.nn.resnet import CustomResNet, ResNet50, TinyCNN
from bench_port.reference.nn.sfa import SFA, ChannelSpatialStage
from bench_port.reference.nn.swin import SwinTransformer
from bench_port.reference.nn.unet import UNet

__all__ = [
    "ASPP", "BasicBlock", "Bottleneck", "ChannelSpatialStage", "ConvBNReLU",
    "CustomFPN", "CustomResNet", "DeformConv", "DepthNet", "FPN_LSS",
    "HeightNet", "Mlp", "OccHead", "ResNet50", "SELayer", "SFA",
    "SwinTransformer", "TinyCNN", "UNet", "upsample_bilinear_align",
]
