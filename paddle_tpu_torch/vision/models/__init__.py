"""The model zoo of `paddle_tpu/vision/models`, PyTorch port: every
constructor the reference exports, under its name."""
from .alexnet import AlexNet, alexnet  # noqa: F401
from .densenet import (DenseNet, densenet121, densenet161,  # noqa: F401
                       densenet169, densenet201, densenet264)
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .mobilenetv1 import MobileNetV1, mobilenet_v1  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
from .mobilenetv3 import (MobileNetV3Large, MobileNetV3Small,  # noqa: F401
                          mobilenet_v3_large, mobilenet_v3_small)
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_swish,  # noqa: F401
                           shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                           shufflenet_v2_x0_5, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .vit import (PatchEmbed, VisionTransformer, vit_b_16,  # noqa: F401
                  vit_l_16, vit_l_32)

__all__ = [
    "AlexNet", "alexnet", "DenseNet", "densenet121", "densenet161",
    "densenet169", "densenet201", "densenet264", "GoogLeNet", "googlenet",
    "InceptionV3", "inception_v3", "LeNet", "MobileNetV1", "mobilenet_v1",
    "MobileNetV2", "mobilenet_v2", "MobileNetV3Small", "MobileNetV3Large",
    "mobilenet_v3_small", "mobilenet_v3_large", "BasicBlock",
    "BottleneckBlock", "ResNet", "resnet18", "resnet34", "resnet50",
    "resnet101", "resnet152", "wide_resnet50_2", "wide_resnet101_2",
    "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
    "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "shufflenet_v2_swish", "SqueezeNet",
    "squeezenet1_0", "squeezenet1_1", "VGG", "vgg11", "vgg13", "vgg16",
    "vgg19", "PatchEmbed", "VisionTransformer", "vit_b_16", "vit_l_16",
    "vit_l_32"]
