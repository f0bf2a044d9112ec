"""MobileNetV1, PyTorch port of `paddle_tpu/vision/models/mobilenetv1.py`
(depthwise-separable stacks). ``device=None`` means ``cuda``; weights from
`seed`."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer.activation import ReLU
from ...nn.layer.common import Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D
from ._common import device_and_generator, no_pretrained

__all__ = ["MobileNetV1", "mobilenet_v1"]


class ConvBNLayer(Sequential):
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, groups=1,
                 device=None, generator=None):
        dg = dict(device=device, generator=generator)
        super().__init__(
            Conv2D(in_ch, out_ch, kernel, stride=stride, padding=padding,
                   groups=groups, bias_attr=False, **dg),
            BatchNorm2D(out_ch, **dg), ReLU())


class DepthwiseSeparable(Sequential):
    def __init__(self, in_ch, out_ch1, out_ch2, num_groups, stride, scale,
                 device=None, generator=None):
        dg = dict(device=device, generator=generator)
        super().__init__(
            ConvBNLayer(in_ch, int(out_ch1 * scale), 3, stride=stride,
                        padding=1, groups=int(num_groups * scale), **dg),
            ConvBNLayer(int(out_ch1 * scale), int(out_ch2 * scale), 1, **dg))


class MobileNetV1(nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        dg = device_and_generator(device, seed)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2, padding=1,
                                 **dg)
        cfg = [
            # in, ch1, ch2, groups, stride
            (32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
            (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
            (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
            (1024, 1024, 1024, 1024, 1)]
        self.dwsl = Sequential(*[
            DepthwiseSeparable(int(i * scale), c1, c2, g, s, scale, **dg)
            for i, c1, c2, g, s in cfg])
        if with_pool:
            self.pool2d_avg = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(int(1024 * scale), num_classes, **dg)

    def forward(self, x):
        x = self.dwsl(self.conv1(x))
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)
