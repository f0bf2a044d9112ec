"""GoogLeNet (Inception v1), PyTorch port of
`paddle_tpu/vision/models/googlenet.py`: with a head it returns ``(out,
aux1, aux2)`` in training and in evaluation alike, as the reference does
(its aux heads need the 14 x 14 grid of a 224 input). ``device=None``
means ``cuda``; weights from `seed`."""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer.activation import ReLU
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from ._common import device_and_generator, no_pretrained

__all__ = ["GoogLeNet", "googlenet"]


class ConvLayer(nn.Module):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 groups=1, device=None, generator=None):
        super().__init__()
        self.conv = Conv2D(num_channels, num_filters, filter_size,
                           stride=stride, padding=(filter_size - 1) // 2,
                           groups=groups, bias_attr=False, device=device,
                           generator=generator)
        self.relu = ReLU()

    def forward(self, x):
        return self.relu(self.conv(x))


class Inception(nn.Module):
    def __init__(self, in_ch, f1, f3r, f3, f5r, f5, proj, device=None,
                 generator=None):
        super().__init__()
        dg = dict(device=device, generator=generator)
        self.branch1 = ConvLayer(in_ch, f1, 1, **dg)
        self.branch2 = Sequential(ConvLayer(in_ch, f3r, 1, **dg),
                                  ConvLayer(f3r, f3, 3, **dg))
        self.branch3 = Sequential(ConvLayer(in_ch, f5r, 1, **dg),
                                  ConvLayer(f5r, f5, 5, **dg))
        self.branch4 = Sequential(
            MaxPool2D(kernel_size=3, stride=1, padding=1),
            ConvLayer(in_ch, proj, 1, **dg))

    def forward(self, x):
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x),
                          self.branch4(x)], dim=1)


class GoogLeNet(nn.Module):
    def __init__(self, num_classes=1000, with_pool=True, device=None, seed=0):
        super().__init__()
        dg = device_and_generator(device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvLayer(3, 64, 7, stride=2, **dg)
        self.pool1 = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.conv2 = ConvLayer(64, 64, 1, **dg)
        self.conv3 = ConvLayer(64, 192, 3, **dg)
        self.pool2 = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.ince3a = Inception(192, 64, 96, 128, 16, 32, 32, **dg)
        self.ince3b = Inception(256, 128, 128, 192, 32, 96, 64, **dg)
        self.pool3 = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.ince4a = Inception(480, 192, 96, 208, 16, 48, 64, **dg)
        self.ince4b = Inception(512, 160, 112, 224, 24, 64, 64, **dg)
        self.ince4c = Inception(512, 128, 128, 256, 24, 64, 64, **dg)
        self.ince4d = Inception(512, 112, 144, 288, 32, 64, 64, **dg)
        self.ince4e = Inception(528, 256, 160, 320, 32, 128, 128, **dg)
        self.pool4 = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.ince5a = Inception(832, 256, 160, 320, 32, 128, 128, **dg)
        self.ince5b = Inception(832, 384, 192, 384, 48, 128, 128, **dg)
        if with_pool:
            self.pool5 = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.4)
            self.fc = Linear(1024, num_classes, **dg)
            # the aux heads (deep supervision in training)
            self.pool_aux1 = AvgPool2D(5, stride=3)
            self.conv_aux1 = ConvLayer(512, 128, 1, **dg)
            self.fc_aux1a = Linear(128 * 4 * 4, 1024, **dg)
            self.relu_aux = ReLU()
            self.drop_aux = Dropout(0.7)
            self.fc_aux1b = Linear(1024, num_classes, **dg)
            self.pool_aux2 = AvgPool2D(5, stride=3)
            self.conv_aux2 = ConvLayer(528, 128, 1, **dg)
            self.fc_aux2a = Linear(128 * 4 * 4, 1024, **dg)
            self.fc_aux2b = Linear(1024, num_classes, **dg)

    def _aux(self, x, pool, conv, fca, fcb):
        x = torch.flatten(conv(pool(x)), 1)
        return fcb(self.drop_aux(self.relu_aux(fca(x))))

    def forward(self, x):
        x = self.pool1(self.conv1(x))
        x = self.pool2(self.conv3(self.conv2(x)))
        x = self.pool3(self.ince3b(self.ince3a(x)))
        x = self.ince4a(x)
        aux1_in = x
        x = self.ince4d(self.ince4c(self.ince4b(x)))
        aux2_in = x
        x = self.pool4(self.ince4e(x))
        x = self.ince5b(self.ince5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            out = self.fc(self.dropout(torch.flatten(x, 1)))
            out1 = self._aux(aux1_in, self.pool_aux1, self.conv_aux1,
                             self.fc_aux1a, self.fc_aux1b)
            out2 = self._aux(aux2_in, self.pool_aux2, self.conv_aux2,
                             self.fc_aux2a, self.fc_aux2b)
            return out, out1, out2
        return x


def googlenet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return GoogLeNet(**kwargs)
