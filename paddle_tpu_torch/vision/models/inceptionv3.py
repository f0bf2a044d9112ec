"""Inception v3, PyTorch port of `paddle_tpu/vision/models/inceptionv3.py`
(stem, Inception A/B/C/D/E blocks, 299 x 299 inputs). ``device=None``
means ``cuda``; weights from `seed`."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer.activation import ReLU
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from ._common import device_and_generator, no_pretrained

__all__ = ["InceptionV3", "inception_v3"]


class ConvBNLayer(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0,
                 device=None, generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.conv = Conv2D(in_ch, out_ch, kernel, stride=stride,
                           padding=padding, bias_attr=False, **dg)
        self.bn = BatchNorm2D(out_ch, **dg)
        self.relu = ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class InceptionStem(nn.Module):
    def __init__(self, device=None, generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.conv_1a = ConvBNLayer(3, 32, 3, stride=2, **dg)
        self.conv_2a = ConvBNLayer(32, 32, 3, **dg)
        self.conv_2b = ConvBNLayer(32, 64, 3, padding=1, **dg)
        self.pool1 = MaxPool2D(kernel_size=3, stride=2)
        self.conv_3b = ConvBNLayer(64, 80, 1, **dg)
        self.conv_4a = ConvBNLayer(80, 192, 3, **dg)
        self.pool2 = MaxPool2D(kernel_size=3, stride=2)

    def forward(self, x):
        x = self.pool1(self.conv_2b(self.conv_2a(self.conv_1a(x))))
        return self.pool2(self.conv_4a(self.conv_3b(x)))


class InceptionA(nn.Module):
    def __init__(self, in_ch, pool_features, device=None, generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.b1 = ConvBNLayer(in_ch, 64, 1, **dg)
        self.b5 = Sequential(ConvBNLayer(in_ch, 48, 1, **dg),
                             ConvBNLayer(48, 64, 5, padding=2, **dg))
        self.b3 = Sequential(ConvBNLayer(in_ch, 64, 1, **dg),
                             ConvBNLayer(64, 96, 3, padding=1, **dg),
                             ConvBNLayer(96, 96, 3, padding=1, **dg))
        self.pool = Sequential(AvgPool2D(3, stride=1, padding=1),
                               ConvBNLayer(in_ch, pool_features, 1, **dg))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x), self.pool(x)],
                         dim=1)


class InceptionB(nn.Module):
    """Grid-size reduction 35 -> 17."""

    def __init__(self, in_ch, device=None, generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.b3 = ConvBNLayer(in_ch, 384, 3, stride=2, **dg)
        self.b3d = Sequential(ConvBNLayer(in_ch, 64, 1, **dg),
                              ConvBNLayer(64, 96, 3, padding=1, **dg),
                              ConvBNLayer(96, 96, 3, stride=2, **dg))
        self.pool = MaxPool2D(kernel_size=3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch, channels_7x7, device=None, generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        c7 = channels_7x7
        self.b1 = ConvBNLayer(in_ch, 192, 1, **dg)
        self.b7 = Sequential(
            ConvBNLayer(in_ch, c7, 1, **dg),
            ConvBNLayer(c7, c7, (1, 7), padding=(0, 3), **dg),
            ConvBNLayer(c7, 192, (7, 1), padding=(3, 0), **dg))
        self.b7d = Sequential(
            ConvBNLayer(in_ch, c7, 1, **dg),
            ConvBNLayer(c7, c7, (7, 1), padding=(3, 0), **dg),
            ConvBNLayer(c7, c7, (1, 7), padding=(0, 3), **dg),
            ConvBNLayer(c7, c7, (7, 1), padding=(3, 0), **dg),
            ConvBNLayer(c7, 192, (1, 7), padding=(0, 3), **dg))
        self.pool = Sequential(AvgPool2D(3, stride=1, padding=1),
                               ConvBNLayer(in_ch, 192, 1, **dg))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x), self.pool(x)],
                         dim=1)


class InceptionD(nn.Module):
    """Grid-size reduction 17 -> 8."""

    def __init__(self, in_ch, device=None, generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.b3 = Sequential(ConvBNLayer(in_ch, 192, 1, **dg),
                             ConvBNLayer(192, 320, 3, stride=2, **dg))
        self.b7 = Sequential(
            ConvBNLayer(in_ch, 192, 1, **dg),
            ConvBNLayer(192, 192, (1, 7), padding=(0, 3), **dg),
            ConvBNLayer(192, 192, (7, 1), padding=(3, 0), **dg),
            ConvBNLayer(192, 192, 3, stride=2, **dg))
        self.pool = MaxPool2D(kernel_size=3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch, device=None, generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.b1 = ConvBNLayer(in_ch, 320, 1, **dg)
        self.b3_1 = ConvBNLayer(in_ch, 384, 1, **dg)
        self.b3_2a = ConvBNLayer(384, 384, (1, 3), padding=(0, 1), **dg)
        self.b3_2b = ConvBNLayer(384, 384, (3, 1), padding=(1, 0), **dg)
        self.b3d_1 = ConvBNLayer(in_ch, 448, 1, **dg)
        self.b3d_2 = ConvBNLayer(448, 384, 3, padding=1, **dg)
        self.b3d_3a = ConvBNLayer(384, 384, (1, 3), padding=(0, 1), **dg)
        self.b3d_3b = ConvBNLayer(384, 384, (3, 1), padding=(1, 0), **dg)
        self.pool = Sequential(AvgPool2D(3, stride=1, padding=1),
                               ConvBNLayer(in_ch, 192, 1, **dg))

    def forward(self, x):
        b3 = self.b3_1(x)
        b3 = torch.cat([self.b3_2a(b3), self.b3_2b(b3)], dim=1)
        b3d = self.b3d_2(self.b3d_1(x))
        b3d = torch.cat([self.b3d_3a(b3d), self.b3d_3b(b3d)], dim=1)
        return torch.cat([self.b1(x), b3, b3d, self.pool(x)], dim=1)


class InceptionV3(nn.Module):
    def __init__(self, num_classes=1000, with_pool=True, device=None, seed=0):
        super().__init__()
        dg = device_and_generator(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = InceptionStem(**dg)
        self.blocks = Sequential(
            InceptionA(192, 32, **dg), InceptionA(256, 64, **dg),
            InceptionA(288, 64, **dg), InceptionB(288, **dg),
            InceptionC(768, 128, **dg), InceptionC(768, 160, **dg),
            InceptionC(768, 160, **dg), InceptionC(768, 192, **dg),
            InceptionD(768, **dg), InceptionE(1280, **dg),
            InceptionE(2048, **dg))
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.2)
            self.fc = Linear(2048, num_classes, **dg)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(torch.flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return InceptionV3(**kwargs)
