"""Vision surface of the port (counterpart of paddle_tpu/vision): the
model zoo (`vision.models`) and the detection ops (`vision.ops`)."""
from . import models, ops
from .models import (AlexNet, LeNet, MobileNetV1, MobileNetV2, ResNet,
                     SqueezeNet, VGG, alexnet, mobilenet_v1, mobilenet_v2,
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     squeezenet1_0, squeezenet1_1, vgg11, vgg13, vgg16,
                     vgg19)

__all__ = ["models", "ops", "LeNet", "AlexNet", "VGG", "ResNet",
           "MobileNetV1", "MobileNetV2", "SqueezeNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152", "alexnet",
           "vgg11", "vgg13", "vgg16", "vgg19", "mobilenet_v1",
           "mobilenet_v2", "squeezenet1_0", "squeezenet1_1"]
