"""AlexNet, PyTorch port of `paddle_tpu/vision/models/alexnet.py`.
``device=None`` means ``cuda``; weights from `seed`."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer.activation import ReLU
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.pooling import AdaptiveAvgPool2D, MaxPool2D
from ._common import device_and_generator, no_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(nn.Module):
    def __init__(self, num_classes=1000, device=None, seed=0):
        super().__init__()
        dg = device_and_generator(device, seed)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, **dg), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(64, 192, 5, padding=2, **dg), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(192, 384, 3, padding=1, **dg), ReLU(),
            Conv2D(384, 256, 3, padding=1, **dg), ReLU(),
            Conv2D(256, 256, 3, padding=1, **dg), ReLU(),
            MaxPool2D(3, 2))
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        self.classifier = Sequential(
            Dropout(), Linear(256 * 6 * 6, 4096, **dg), ReLU(),
            Dropout(), Linear(4096, 4096, **dg), ReLU(),
            Linear(4096, num_classes, **dg))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(torch.flatten(x, 1))


def alexnet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return AlexNet(**kwargs)
