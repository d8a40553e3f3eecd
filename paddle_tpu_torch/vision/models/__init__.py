"""Vision models of the port (counterpart of paddle_tpu/vision/models):
LeNet, AlexNet, VGG, MobileNetV1 / V2, SqueezeNet, PP-YOLOE, the
Vision Transformers, and the ResNets re-exported from the core model zoo
(`paddle_tpu_torch.models.resnet`), as the JAX package does."""
from ...models.resnet import (ResNet, resnet18, resnet34, resnet50,
                              resnet101, resnet152, wide_resnet50_2,
                              wide_resnet101_2)
from ...models.resnet import train_flops_per_image as _resnet_flops
from .alexnet import AlexNet, alexnet
from .lenet import LeNet
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .vit import VisionTransformer, vit_b_16, vit_l_16, vit_s_16, vit_tiny
from .vit import train_flops_per_image as _vit_flops
from .yolo import PPYOLOE, ppyoloe_s
from .yolo import train_flops_per_image as _yolo_flops

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "wide_resnet50_2", "wide_resnet101_2", "LeNet",
           "AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2",
           "SqueezeNet", "squeezenet1_0", "squeezenet1_1", "PPYOLOE",
           "ppyoloe_s", "VisionTransformer", "vit_b_16", "vit_l_16",
           "vit_s_16", "vit_tiny", "train_flops_per_image"]


def train_flops_per_image(model, image_size):
    """Analytic training FLOPs per square image (3 x the forward's
    products, 2 per multiply-add) of a `ResNet`, `PPYOLOE` or
    `VisionTransformer` — the MFU numerator."""
    for cls, fn in ((ResNet, _resnet_flops), (PPYOLOE, _yolo_flops),
                    (VisionTransformer, _vit_flops)):
        if isinstance(model, cls):
            return fn(model, image_size)
    raise TypeError(f"no FLOPs count for {type(model).__name__}")
