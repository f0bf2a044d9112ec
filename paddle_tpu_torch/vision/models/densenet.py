"""DenseNet family, PyTorch port of `paddle_tpu/vision/models/densenet.py`
(dense blocks of BN-ReLU-conv layers whose outputs are concatenated).
``device=None`` means ``cuda``; weights from `seed`."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer.activation import ReLU
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.container import LayerList, Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from ._common import device_and_generator, no_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFG = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class _DenseLayer(nn.Module):
    def __init__(self, num_channels, growth_rate, bn_size, dropout,
                 device=None, generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.bn1 = BatchNorm2D(num_channels, **dg)
        self.relu = ReLU()
        self.conv1 = Conv2D(num_channels, bn_size * growth_rate, 1,
                            bias_attr=False, **dg)
        self.bn2 = BatchNorm2D(bn_size * growth_rate, **dg)
        self.conv2 = Conv2D(bn_size * growth_rate, growth_rate, 3, padding=1,
                            bias_attr=False, **dg)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], dim=1)


class _Transition(nn.Module):
    def __init__(self, num_channels, num_output, device=None, generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.bn = BatchNorm2D(num_channels, **dg)
        self.relu = ReLU()
        self.conv = Conv2D(num_channels, num_output, 1, bias_attr=False, **dg)
        self.pool = AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(nn.Module):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, device=None, seed=0):
        super().__init__()
        dg = device_and_generator(device, seed)
        num_init_features, growth_rate, block_config = _CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.features = Sequential(
            Conv2D(3, num_init_features, 7, stride=2, padding=3,
                   bias_attr=False, **dg),
            BatchNorm2D(num_init_features, **dg), ReLU(),
            MaxPool2D(kernel_size=3, stride=2, padding=1))
        self.blocks = LayerList()
        num_channels = num_init_features
        for i, num_layers in enumerate(block_config):
            self.blocks.append(Sequential(*[
                _DenseLayer(num_channels + j * growth_rate, growth_rate,
                            bn_size, dropout, **dg)
                for j in range(num_layers)]))
            num_channels += num_layers * growth_rate
            if i != len(block_config) - 1:
                self.blocks.append(_Transition(num_channels,
                                               num_channels // 2, **dg))
                num_channels //= 2
        self.bn_final = BatchNorm2D(num_channels, **dg)
        self.relu_final = ReLU()
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Linear(num_channels, num_classes, **dg)

    def forward(self, x):
        x = self.features(x)
        for blk in self.blocks:
            x = blk(x)
        x = self.relu_final(self.bn_final(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _densenet(layers, pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
