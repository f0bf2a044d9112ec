"""ShuffleNet V2, PyTorch port of `paddle_tpu/vision/models/shufflenetv2.py`
(channel split and shuffle units). ``device=None`` means ``cuda``; weights
from `seed`."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer.activation import ReLU, Swish
from ...nn.layer.common import ChannelShuffle, Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D, MaxPool2D
from ._common import device_and_generator, no_pretrained

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]


def _conv_bn_act(in_ch, out_ch, kernel, stride, groups=1, act="relu",
                 device=None, generator=None):
    dg = dict(device=device, generator=generator)
    layers = [Conv2D(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2,
                     groups=groups, bias_attr=False, **dg),
              BatchNorm2D(out_ch, **dg)]
    if act == "relu":
        layers.append(ReLU())
    elif act == "swish":
        layers.append(Swish())
    return Sequential(*layers)


class InvertedResidual(nn.Module):
    def __init__(self, in_ch, out_ch, stride, act="relu", device=None,
                 generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.stride = stride
        branch_ch = out_ch // 2
        if stride == 1:
            self.branch2 = Sequential(
                _conv_bn_act(branch_ch, branch_ch, 1, 1, act=act, **dg),
                _conv_bn_act(branch_ch, branch_ch, 3, 1, groups=branch_ch,
                             act="none", **dg),
                _conv_bn_act(branch_ch, branch_ch, 1, 1, act=act, **dg))
        else:
            self.branch1 = Sequential(
                _conv_bn_act(in_ch, in_ch, 3, stride, groups=in_ch,
                             act="none", **dg),
                _conv_bn_act(in_ch, branch_ch, 1, 1, act=act, **dg))
            self.branch2 = Sequential(
                _conv_bn_act(in_ch, branch_ch, 1, 1, act=act, **dg),
                _conv_bn_act(branch_ch, branch_ch, 3, stride,
                             groups=branch_ch, act="none", **dg),
                _conv_bn_act(branch_ch, branch_ch, 1, 1, act=act, **dg))
        self.shuffle = ChannelShuffle(2)

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            x1, x2 = x[:, :half], x[:, half:]
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return self.shuffle(out)


class ShuffleNetV2(nn.Module):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, device=None, seed=0):
        super().__init__()
        dg = device_and_generator(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        stage_repeats = [4, 8, 4]
        ch_map = {0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
                  0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
                  1.5: [24, 176, 352, 704, 1024],
                  2.0: [24, 244, 488, 976, 2048]}
        stage_out = ch_map[scale]
        self.conv1 = _conv_bn_act(3, stage_out[0], 3, 2, act=act, **dg)
        self.max_pool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        blocks = []
        in_ch = stage_out[0]
        for stage_i, repeats in enumerate(stage_repeats):
            out_ch = stage_out[stage_i + 1]
            for i in range(repeats):
                blocks.append(InvertedResidual(in_ch, out_ch,
                                               stride=2 if i == 0 else 1,
                                               act=act, **dg))
                in_ch = out_ch
        self.blocks = Sequential(*blocks)
        self.conv_last = _conv_bn_act(in_ch, stage_out[-1], 1, 1, act=act,
                                      **dg)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(stage_out[-1], num_classes, **dg)

    def forward(self, x):
        x = self.max_pool(self.conv1(x))
        x = self.conv_last(self.blocks(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _shufflenet(scale, act="relu", pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet(0.25, pretrained=pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet(0.33, pretrained=pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet(0.5, pretrained=pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet(1.0, pretrained=pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet(1.5, pretrained=pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet(2.0, pretrained=pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet(1.0, act="swish", pretrained=pretrained, **kwargs)
