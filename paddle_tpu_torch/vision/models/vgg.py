"""VGG, PyTorch port of `paddle_tpu/vision/models/vgg.py` (configs A, B, D,
E; ``batch_norm=True`` puts a `BatchNorm2D` after every convolution).
``device=None`` means ``cuda``; weights from `seed`."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer.activation import ReLU
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D, MaxPool2D
from ._common import device_and_generator, no_pretrained

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
          "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


def _make_layers(cfg, batch_norm, dg):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(in_c, v, 3, padding=1, **dg))
            if batch_norm:
                layers.append(BatchNorm2D(v, **dg))
            layers.append(ReLU())
            in_c = v
    return Sequential(*layers)


class VGG(nn.Module):
    """`features` is a `Sequential` of the trunk (`_make_layers`); the
    classifier is built on the device of its first parameter, from
    `seed`."""

    def __init__(self, features, num_classes=1000, with_pool=True, seed=0):
        super().__init__()
        dg = device_and_generator(next(features.parameters()).device, seed)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096, **dg), ReLU(), Dropout(),
                Linear(4096, 4096, **dg), ReLU(), Dropout(),
                Linear(4096, num_classes, **dg))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _vgg(cfg, batch_norm=False, pretrained=False, device=None, seed=0,
         **kwargs):
    no_pretrained(pretrained)
    # the trunk from `seed`, the classifier from the next seed
    dg = device_and_generator(device, seed)
    return VGG(_make_layers(_CFGS[cfg], batch_norm, dg), seed=seed + 1,
               **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
