"""Convolution layers, PyTorch port.

Counterpart of `paddle_tpu/nn/layer/conv.py`: `Conv1D` / `Conv2D` /
`Conv3D` and `Conv1DTranspose` / `Conv2DTranspose` / `Conv3DTranspose`
over `nn.functional.conv`, with Paddle's arguments. Parameters are
``weight`` (``[out, in / groups, *k]``, a transpose's ``[in, out / groups,
*k]``) and ``bias`` (``[out]``; none for ``bias_attr=False``), both drawn
from U(±1/sqrt(fan_in)) with fan_in = in · prod(k) / groups, the
reference's default for either (reference :38-45), unless an attr names an
initializer.

``padding_mode``: the reference stores it and never applies it (reference
:60-75; ROADMAP.md Queue 3), so its convolutions always pad with zeros.
The port takes ``"zeros"`` and raises ValueError on any other mode rather
than ignore it.

``device=None`` means ``cuda`` and raises where there is no card;
``generator`` is a `torch.Generator` on that device (torch's default one
when None).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride, padding,
                 dilation, groups, padding_mode, weight_attr, bias_attr,
                 data_format, dims, transposed=False, output_padding=0,
                 device=None, generator=None):
        super().__init__()
        if in_channels % groups != 0:
            raise ValueError("in_channels must be divisible by groups")
        if padding_mode != "zeros":
            raise ValueError(
                f"padding_mode {padding_mode!r} is not supported: the "
                f"reference stores the mode and pads with zeros whatever it "
                f"says, so only 'zeros' is taken")
        device = resolve_device(device)
        self._in_channels = in_channels
        self._out_channels = out_channels
        ks = kernel_size if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * dims
        self._kernel_size = tuple(int(k) for k in ks)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._padding_mode = padding_mode
        self._output_padding = output_padding
        if transposed:
            shape = [in_channels, out_channels // groups, *self._kernel_size]
        else:
            shape = [out_channels, in_channels // groups, *self._kernel_size]
        fan_in = in_channels * math.prod(self._kernel_size) // groups
        std = (1.0 / fan_in) ** 0.5
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        I.from_attr(weight_attr, I.Uniform(-std, std))(self.weight, generator)
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.empty(out_channels, device=device))
            I.from_attr(bias_attr, I.Uniform(-std, std))(self.bias, generator)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, 1, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, 2, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, 3, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class _ConvTransposeNd(_ConvNd):
    _dims = 0
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format=None,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, self._dims, transposed=True,
                         output_padding=output_padding, device=device,
                         generator=generator)

    def forward(self, x, output_size=None):
        return self._fn(x, self.weight, self.bias, self._stride,
                        self._padding, self._output_padding, self._groups,
                        self._dilation, output_size, self._data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _dims = 1
    _fn = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None, generator=None):
        # the reference's 1-D transpose takes groups before dilation
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, device,
                         generator)


class Conv2DTranspose(_ConvTransposeNd):
    _dims = 2
    _fn = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, device,
                         generator)


class Conv3DTranspose(_ConvTransposeNd):
    _dims = 3
    _fn = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, device,
                         generator)
