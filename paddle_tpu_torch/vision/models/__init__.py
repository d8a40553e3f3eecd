"""Vision models of the port (counterpart of paddle_tpu/vision/models):
LeNet, AlexNet, VGG, MobileNetV1 / V2 / V3, SqueezeNet, ShuffleNetV2,
DenseNet, GoogLeNet, InceptionV3, ResNeXt, PP-YOLOE, the Vision
Transformers, and the ResNets re-exported from the core model zoo
(`paddle_tpu_torch.models.resnet`), as the JAX package does."""
from ...models.resnet import (ResNet, resnet18, resnet34, resnet50,
                              resnet101, resnet152, wide_resnet50_2,
                              wide_resnet101_2)
from ._blocks import train_flops_per_image as _cnn_flops
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .googlenet import GoogLeNet, InceptionV3, googlenet, inception_v3
from .lenet import LeNet
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2
from .resnext import (ResNeXt, resnext50_32x4d, resnext50_64x4d,
                      resnext101_32x4d, resnext101_64x4d, resnext152_32x4d,
                      resnext152_64x4d)
from .shufflenetv2 import (MobileNetV3, MobileNetV3Large, MobileNetV3Small,
                           ShuffleNetV2, mobilenet_v3_large,
                           mobilenet_v3_small, shufflenet_v2_swish,
                           shufflenet_v2_x0_5, shufflenet_v2_x0_25,
                           shufflenet_v2_x0_33, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .vit import VisionTransformer, vit_b_16, vit_l_16, vit_s_16, vit_tiny
from .vit import train_flops_per_image as _vit_flops
from .yolo import PPYOLOE, ppyoloe_s

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "wide_resnet50_2", "wide_resnet101_2", "LeNet",
           "AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2",
           "SqueezeNet", "squeezenet1_0", "squeezenet1_1", "PPYOLOE",
           "ppyoloe_s", "VisionTransformer", "vit_b_16", "vit_l_16",
           "vit_s_16", "vit_tiny", "DenseNet", "densenet121", "densenet161",
           "densenet169", "densenet201", "densenet264", "GoogLeNet",
           "googlenet", "InceptionV3", "inception_v3", "ShuffleNetV2",
           "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish", "MobileNetV3",
           "MobileNetV3Large", "MobileNetV3Small", "mobilenet_v3_large",
           "mobilenet_v3_small", "ResNeXt", "resnext50_32x4d",
           "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
           "resnext152_32x4d", "resnext152_64x4d", "train_flops_per_image"]


def train_flops_per_image(model, image_size):
    """Training FLOPs per square image (3 x the forward's products, 2 per
    multiply-add) of a `ResNet` (ResNeXt too), `PPYOLOE`,
    `VisionTransformer`, `DenseNet`, `GoogLeNet`, `InceptionV3`,
    `ShuffleNetV2` or `MobileNetV3` — the MFU numerator. The CNNs are
    counted over the `Conv2D` and `Linear` products one forward runs; ViT
    analytically (that forward would launch the flash kernels)."""
    if isinstance(model, VisionTransformer):
        return _vit_flops(model, image_size)
    if isinstance(model, (ResNet, PPYOLOE, DenseNet, GoogLeNet, InceptionV3,
                          ShuffleNetV2, MobileNetV3)):
        return _cnn_flops(model, image_size)
    raise TypeError(f"no FLOPs count for {type(model).__name__}")
