"""Normalization layers, PyTorch port.

Counterpart of `paddle_tpu/nn/layer/norm.py`'s `BatchNorm`,
`BatchNorm1D` / `2D` / `3D`, `SyncBatchNorm`, `GroupNorm`,
`InstanceNorm1D` / `2D` / `3D` and `LocalResponseNorm`, over
`nn.functional.norm`.

A batch norm holds ``weight`` (ones) and ``bias`` (zeros) and two fp32
buffers under the reference's names, ``_mean`` (zeros) and ``_variance``
(ones), which `state_dict` carries and a training forward moves in place
(Paddle's ``momentum=0.9``: ``running = 0.9 · running + 0.1 · batch``).
There is no ``num_batches_tracked``. `SyncBatchNorm` is a batch norm in
one process, as the reference's is outside a mesh;
`SyncBatchNorm.convert_sync_batchnorm(layer)` swaps every batch norm of
`layer` for one that shares its parameters and buffers. An instance
norm's parameters are ``scale`` and ``bias`` (none when either attr is
False), as the reference names them.

``device=None`` means ``cuda`` and raises where there is no card.
"""
from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "LocalResponseNorm"]


def _affine_pair(module, n, weight_attr, bias_attr, device, generator,
                 weight_name="weight"):
    """A ``[n]`` weight (ones) and bias (zeros) from the attrs."""
    for name, attr, default in ((weight_name, weight_attr, I.Constant(1.0)),
                                ("bias", bias_attr, I.Constant(0.0))):
        if attr is False:
            module.register_parameter(name, None)
            continue
        p = nn.Parameter(torch.empty(n, device=device))
        I.from_attr(attr, default)(p, generator)
        module.register_parameter(name, p)


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        _affine_pair(self, num_features, weight_attr, bias_attr, device,
                     generator)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, input):
        return F.batch_norm(input, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm; in one process a batch norm."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format,
                      use_global_stats=layer._use_global_stats,
                      device=layer._mean.device)
            out.weight = layer.weight
            out.bias = layer.bias
            out._mean = layer._mean
            out._variance = layer._variance
            out.train(layer.training)
        for name, sub in list(layer.named_children()):
            converted = cls.convert_sync_batchnorm(sub)
            if converted is not sub:
                out.add_module(name, converted)
        return out


class GroupNorm(nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, generator=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        _affine_pair(self, num_channels, weight_attr, bias_attr,
                     resolve_device(device), generator)

    def forward(self, input):
        return F.group_norm(input, self._num_groups, self._epsilon,
                            self.weight, self.bias, self._data_format)


class _InstanceNormBase(nn.Module):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, generator=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            self.register_parameter("scale", None)
            self.register_parameter("bias", None)
        else:
            _affine_pair(self, num_features, weight_attr, bias_attr,
                         resolve_device(device), generator,
                         weight_name="scale")

    def forward(self, input):
        return F.instance_norm(input, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(nn.Module):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, input):
        return F.local_response_norm(input, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)
