"""MobileNetV3 Small / Large, PyTorch port of
`paddle_tpu/vision/models/mobilenetv3.py` (inverted residuals with
squeeze-excitation, hardswish). ``device=None`` means ``cuda``; weights
from `seed`."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer.activation import Hardsigmoid, Hardswish, ReLU
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D
from ._common import device_and_generator, no_pretrained

__all__ = ["MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNActivation(Sequential):
    def __init__(self, in_ch, out_ch, kernel, stride=1, groups=1, act=None,
                 device=None, generator=None):
        dg = dict(device=device, generator=generator)
        layers = [Conv2D(in_ch, out_ch, kernel, stride=stride,
                         padding=(kernel - 1) // 2, groups=groups,
                         bias_attr=False, **dg),
                  BatchNorm2D(out_ch, **dg)]
        if act == "relu":
            layers.append(ReLU())
        elif act == "hardswish":
            layers.append(Hardswish())
        super().__init__(*layers)


class SqueezeExcitation(nn.Module):
    def __init__(self, in_ch, squeeze_ch, device=None, generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.avgpool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(in_ch, squeeze_ch, 1, **dg)
        self.relu = ReLU()
        self.fc2 = Conv2D(squeeze_ch, in_ch, 1, **dg)
        self.hardsigmoid = Hardsigmoid()

    def forward(self, x):
        s = self.hardsigmoid(self.fc2(self.relu(self.fc1(self.avgpool(x)))))
        return x * s


class InvertedResidual(nn.Module):
    def __init__(self, in_ch, exp_ch, out_ch, kernel, stride, use_se, act,
                 device=None, generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if exp_ch != in_ch:
            layers.append(ConvBNActivation(in_ch, exp_ch, 1, act=act, **dg))
        layers.append(ConvBNActivation(exp_ch, exp_ch, kernel, stride=stride,
                                       groups=exp_ch, act=act, **dg))
        if use_se:
            layers.append(SqueezeExcitation(exp_ch,
                                            _make_divisible(exp_ch // 4),
                                            **dg))
        layers.append(ConvBNActivation(exp_ch, out_ch, 1, act=None, **dg))
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


# (kernel, exp, out, use_se, act, stride)
_LARGE_CFG = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1)]
_SMALL_CFG = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1)]


class MobileNetV3(nn.Module):
    def __init__(self, cfg, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True, device=None, seed=0):
        super().__init__()
        dg = device_and_generator(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_ch = _make_divisible(16 * scale)
        self.conv = ConvBNActivation(3, in_ch, 3, stride=2, act="hardswish",
                                     **dg)
        blocks = []
        for k, exp, out, se, act, s in cfg:
            exp_ch = _make_divisible(exp * scale)
            out_ch = _make_divisible(out * scale)
            blocks.append(InvertedResidual(in_ch, exp_ch, out_ch, k, s, se,
                                           act, **dg))
            in_ch = out_ch
        self.blocks = Sequential(*blocks)
        last_conv_ch = _make_divisible(6 * in_ch)
        last_channel = _make_divisible(last_channel * scale)
        self.lastconv = ConvBNActivation(in_ch, last_conv_ch, 1,
                                         act="hardswish", **dg)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(last_conv_ch, last_channel, **dg), Hardswish(),
                Dropout(0.2), Linear(last_channel, num_classes, **dg))

    def forward(self, x):
        x = self.lastconv(self.blocks(self.conv(x)))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__(_SMALL_CFG, 1024, scale, num_classes, with_pool,
                         device, seed)


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__(_LARGE_CFG, 1280, scale, num_classes, with_pool,
                         device, seed)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
