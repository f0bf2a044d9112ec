"""MobileNetV2, PyTorch port of `paddle_tpu/vision/models/mobilenetv2.py`
(inverted residuals, ReLU6). ``device=None`` means ``cuda``; weights from
`seed`."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer.activation import ReLU6
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D
from ._common import device_and_generator, no_pretrained

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(Sequential):
    def __init__(self, in_planes, out_planes, kernel_size=3, stride=1,
                 groups=1, device=None, generator=None):
        dg = dict(device=device, generator=generator)
        padding = (kernel_size - 1) // 2
        super().__init__(
            Conv2D(in_planes, out_planes, kernel_size, stride, padding,
                   groups=groups, bias_attr=False, **dg),
            BatchNorm2D(out_planes, **dg), ReLU6())


class InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, device=None,
                 generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = self.stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden_dim, kernel_size=1, **dg))
        layers.extend([
            ConvBNReLU(hidden_dim, hidden_dim, stride=stride,
                       groups=hidden_dim, **dg),
            Conv2D(hidden_dim, oup, 1, 1, 0, bias_attr=False, **dg),
            BatchNorm2D(oup, **dg)])
        self.conv = Sequential(*layers)

    def forward(self, x):
        if self.use_res_connect:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        dg = device_and_generator(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = 32
        last_channel = 1280
        inverted_residual_setting = [
            [1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2], [6, 64, 4, 2],
            [6, 96, 3, 1], [6, 160, 3, 2], [6, 320, 1, 1]]
        input_channel = _make_divisible(input_channel * scale)
        self.last_channel = _make_divisible(last_channel * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, stride=2, **dg)]
        for t, c, n, s in inverted_residual_setting:
            output_channel = _make_divisible(c * scale)
            for i in range(n):
                stride = s if i == 0 else 1
                features.append(InvertedResidual(input_channel, output_channel,
                                                 stride, t, **dg))
                input_channel = output_channel
        features.append(ConvBNReLU(input_channel, self.last_channel,
                                   kernel_size=1, **dg))
        self.features = Sequential(*features)
        if with_pool:
            self.pool2d_avg = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2), Linear(self.last_channel, num_classes, **dg))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
