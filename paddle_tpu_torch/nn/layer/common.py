"""Common layers, PyTorch port.

Counterpart of part of `paddle_tpu/nn/layer/common.py`: `Linear`,
`Dropout`, `Flatten`, `Identity` and `ChannelShuffle`. `Linear` is a
torch `nn.Linear` (weight ``[out, in]``, which `convert` transposes from
Paddle's ``[in, out]``) built with the reference's arguments: the weight
XavierNormal, the bias zeros (none for ``bias_attr=False``), unless an
attr names an initializer.

``device=None`` means ``cuda`` and raises where there is no card.
"""
from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I

__all__ = ["Linear", "Dropout", "Flatten", "Identity", "ChannelShuffle"]


class Linear(nn.Linear):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None, generator=None):
        super().__init__(in_features, out_features,
                         bias=bias_attr is not False,
                         device=resolve_device(device))
        I.from_attr(weight_attr, I.XavierNormal())(self.weight, generator)
        if self.bias is not None:
            I.from_attr(bias_attr, I.Constant(0.0))(self.bias, generator)


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, input):
        return F.dropout(input, p=self.p, axis=self.axis,
                         training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, input):
        return torch.flatten(input, self.start_axis, self.stop_axis)


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):
        return input


class ChannelShuffle(nn.Module):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)
