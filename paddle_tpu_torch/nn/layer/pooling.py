"""Pooling layers, PyTorch port.

Counterpart of `paddle_tpu/nn/layer/pooling.py` (and the unpool layers of
its `common.py`): each layer keeps its arguments and calls its function of
`nn.functional.pooling`. They hold no parameters.
"""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D"]


class _Pool(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, exclusive=True, divisor_override=None,
                 data_format=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.return_mask = return_mask
        self.exclusive = exclusive
        self.divisor_override = divisor_override
        self.data_format = data_format

    def extra_repr(self):
        return f"kernel_size={self.kernel_size}, stride={self.stride}"


class AvgPool1D(_Pool):
    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.exclusive, self.ceil_mode)


class AvgPool2D(_Pool):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override, self.data_format or "NCHW")


class AvgPool3D(_Pool):
    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override,
                            self.data_format or "NCDHW")


class MaxPool1D(_Pool):
    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode)


class MaxPool2D(_Pool):
    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format or "NCHW")


class MaxPool3D(_Pool):
    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format or "NCDHW")


class _AdaptivePool(nn.Module):
    def __init__(self, output_size, return_mask=False, data_format=None,
                 name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask
        self.data_format = data_format


class AdaptiveAvgPool1D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size,
                                     self.data_format or "NCHW")


class AdaptiveAvgPool3D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size,
                                     self.data_format or "NCDHW")


class AdaptiveMaxPool1D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool2D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)


class _MaxUnPool(nn.Module):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.data_format = data_format
        self.output_size = output_size

    def forward(self, x, indices):
        kw = {} if self.data_format is None else \
            {"data_format": self.data_format}
        return self._fn(x, indices, self.kernel_size, self.stride,
                        self.padding, output_size=self.output_size, **kw)


class MaxUnPool1D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool1d)


class MaxUnPool2D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool2d)


class MaxUnPool3D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool3d)
