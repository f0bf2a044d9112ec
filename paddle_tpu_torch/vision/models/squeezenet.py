"""SqueezeNet 1.0 / 1.1, PyTorch port of
`paddle_tpu/vision/models/squeezenet.py` (fire modules: squeeze 1 x 1,
then expand 1 x 1 and 3 x 3). ``device=None`` means ``cuda``; weights
from `seed`."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer.activation import ReLU
from ...nn.layer.common import Dropout
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.pooling import AdaptiveAvgPool2D, MaxPool2D
from ._common import device_and_generator, no_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(nn.Module):
    def __init__(self, in_ch, squeeze, expand1, expand3, device=None,
                 generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.squeeze = Conv2D(in_ch, squeeze, 1, **dg)
        self.expand1 = Conv2D(squeeze, expand1, 1, **dg)
        self.expand3 = Conv2D(squeeze, expand3, 3, padding=1, **dg)
        self.relu = ReLU()

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.expand1(x)),
                          self.relu(self.expand3(x))], dim=1)


class SqueezeNet(nn.Module):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        dg = device_and_generator(device, seed)
        self.version = version
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2, **dg), ReLU(),
                MaxPool2D(kernel_size=3, stride=2),
                Fire(96, 16, 64, 64, **dg), Fire(128, 16, 64, 64, **dg),
                Fire(128, 32, 128, 128, **dg),
                MaxPool2D(kernel_size=3, stride=2),
                Fire(256, 32, 128, 128, **dg), Fire(256, 48, 192, 192, **dg),
                Fire(384, 48, 192, 192, **dg), Fire(384, 64, 256, 256, **dg),
                MaxPool2D(kernel_size=3, stride=2),
                Fire(512, 64, 256, 256, **dg))
        else:
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2, padding=1, **dg), ReLU(),
                MaxPool2D(kernel_size=3, stride=2),
                Fire(64, 16, 64, 64, **dg), Fire(128, 16, 64, 64, **dg),
                MaxPool2D(kernel_size=3, stride=2),
                Fire(128, 32, 128, 128, **dg), Fire(256, 32, 128, 128, **dg),
                MaxPool2D(kernel_size=3, stride=2),
                Fire(256, 48, 192, 192, **dg), Fire(384, 48, 192, 192, **dg),
                Fire(384, 64, 256, 256, **dg), Fire(512, 64, 256, 256, **dg))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5), Conv2D(512, num_classes, 1, **dg), ReLU())
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.avgpool(x)
        return torch.flatten(x, 1)


def _squeezenet(version, pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet(version=version, **kwargs)


def squeezenet1_0(pretrained=False, **kwargs):
    return _squeezenet("1.0", pretrained, **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return _squeezenet("1.1", pretrained, **kwargs)
