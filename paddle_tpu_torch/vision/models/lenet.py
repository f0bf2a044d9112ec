"""LeNet, PyTorch port of `paddle_tpu/vision/models/lenet.py` (1 x 28 x
28 inputs). ``device=None`` means ``cuda``; weights from `seed`."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer.activation import ReLU
from ...nn.layer.common import Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.pooling import MaxPool2D
from ._common import device_and_generator

__all__ = ["LeNet"]


class LeNet(nn.Module):
    def __init__(self, num_classes=10, device=None, seed=0):
        super().__init__()
        dg = device_and_generator(device, seed)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **dg), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **dg), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(Linear(400, 120, **dg), Linear(120, 84, **dg),
                                 Linear(84, num_classes, **dg))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
