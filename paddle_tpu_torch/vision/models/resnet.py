"""ResNet family, PyTorch port.

Counterpart of `paddle_tpu/vision/models/resnet.py` (`BasicBlock`,
`BottleneckBlock`, `ResNet` and its thirteen constructors), the
reference's BASELINE config 1 (`resnet50`, ImageNet, 224 x 224). The same
graph from the port's layers: `nn.Conv2D` without bias, `nn.BatchNorm2D`
(running statistics in the ``_mean`` / ``_variance`` buffers), `nn.ReLU`,
`nn.MaxPool2D`, `nn.AdaptiveAvgPool2D` and a `nn.Linear` head. Module,
parameter and buffer names are the reference's, so `convert.load_jax_state`
carries a JAX model's parameters and buffers across.

``device=None`` means ``cuda`` and raises where there is no card; pass
``device="cpu"`` for the CPU. Weights draw from the reference's
initializers (convolutions U(±1/sqrt(fan_in)), the head XavierNormal and
zeros, batch norms ones and zeros) through a `torch.Generator` on that
device seeded with `seed`.
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer.activation import ReLU
from ...nn.layer.common import Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D, MaxPool2D
from ._common import device_and_generator, no_pretrained

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
           "wide_resnet101_2", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
           "resnext152_64x4d"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, device=None,
                 generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        dg = dict(device=device, generator=generator)
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False, **dg)
        self.bn1 = norm_layer(planes, **dg)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **dg)
        self.bn2 = norm_layer(planes, **dg)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, device=None,
                 generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        dg = dict(device=device, generator=generator)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **dg)
        self.bn1 = norm_layer(width, **dg)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation, bias_attr=False,
                            **dg)
        self.bn2 = norm_layer(width, **dg)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, **dg)
        self.bn3 = norm_layer(planes * self.expansion, **dg)
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=None, seed=0):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self._dg = device_and_generator(device, seed)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, **self._dg)
        self.bn1 = self._norm_layer(self.inplanes, **self._dg)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **self._dg)
        del self._dg

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        dg = self._dg
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **dg),
                norm_layer(planes * block.expansion, **dg))
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, self.dilation, norm_layer, **dg)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, **dg))
        return Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(block, depth, width=64, pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return ResNet(block, depth, width=width, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained=pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained=pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained=pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained=pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained=pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, width=4, pretrained=pretrained,
                   groups=32, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, width=4, pretrained=pretrained,
                   groups=64, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, width=4, pretrained=pretrained,
                   groups=32, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, width=4, pretrained=pretrained,
                   groups=64, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, width=4, pretrained=pretrained,
                   groups=32, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, width=4, pretrained=pretrained,
                   groups=64, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, width=128, pretrained=pretrained,
                   **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, width=128, pretrained=pretrained,
                   **kwargs)
