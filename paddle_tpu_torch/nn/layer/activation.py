"""Activation layers, PyTorch port.

Counterpart of `paddle_tpu/nn/layer/activation.py`: each layer calls its
function of `nn.functional.activation` with the arguments it was built
with. The reference's `Hardsigmoid` layer takes no slope or offset (the
functional's defaults, 1/6 and 0.5).
"""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Softmax",
           "LogSoftmax", "Silu", "Swish", "Hardswish", "Hardsigmoid",
           "LeakyReLU", "ELU", "CELU", "SELU", "Softplus", "Softsign",
           "Hardtanh", "Mish", "Tanhshrink", "Hardshrink", "Softshrink",
           "ThresholdedReLU", "LogSigmoid"]


def _layer(cls_name, fname, *arg_names, **defaults):
    """A layer class whose forward is ``F.<fname>(x, **its arguments)``;
    positional arguments fill `arg_names` in order."""
    fn = getattr(F, fname)

    def __init__(self, *args, name=None, **kwargs):
        nn.Module.__init__(self)
        self._kwargs = {**defaults, **dict(zip(arg_names, args)), **kwargs}

    def forward(self, x):
        return fn(x, **self._kwargs)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kwargs.items())

    return type(cls_name, (nn.Module,), {
        "__init__": __init__, "forward": forward, "extra_repr": extra_repr,
        "__doc__": f"``F.{fname}`` as a layer."})


ReLU = _layer("ReLU", "relu")
ReLU6 = _layer("ReLU6", "relu6")
GELU = _layer("GELU", "gelu", "approximate")
Sigmoid = _layer("Sigmoid", "sigmoid")
Tanh = _layer("Tanh", "tanh")
Softmax = _layer("Softmax", "softmax", "axis")
LogSoftmax = _layer("LogSoftmax", "log_softmax", "axis")
Silu = _layer("Silu", "silu")
Swish = _layer("Swish", "swish")
Hardswish = _layer("Hardswish", "hardswish")
Hardsigmoid = _layer("Hardsigmoid", "hardsigmoid")
LeakyReLU = _layer("LeakyReLU", "leaky_relu", "negative_slope")
ELU = _layer("ELU", "elu", "alpha")
CELU = _layer("CELU", "celu", "alpha")
SELU = _layer("SELU", "selu", "scale", "alpha")
Softplus = _layer("Softplus", "softplus", "beta", "threshold")
Softsign = _layer("Softsign", "softsign")
Hardtanh = _layer("Hardtanh", "hardtanh", "min", "max")
Mish = _layer("Mish", "mish")
Tanhshrink = _layer("Tanhshrink", "tanhshrink")
Hardshrink = _layer("Hardshrink", "hardshrink", "threshold")
Softshrink = _layer("Softshrink", "softshrink", "threshold")
ThresholdedReLU = _layer("ThresholdedReLU", "thresholded_relu", "threshold")
LogSigmoid = _layer("LogSigmoid", "log_sigmoid")
