"""Activations under the reference's names and signatures.

Counterpart of `paddle_tpu/nn/functional/activation.py`: the names the
transformer layers take by string (``getattr(F, activation)``: `relu`,
`gelu`, exact unless ``approximate=True``), the ones the vision models
use (`relu6`, `hardswish`, `hardsigmoid` with the reference's `slope` and
`offset`, `swish`, `softmax`) and the other elementwise ones that are one
torch call each. Formulas are the reference's where torch's differ:
`hardsigmoid` is ``clip(slope · x + offset, 0, 1)``, `leaky_relu` keeps
``x`` where ``x >= 0``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

__all__ = ["relu", "relu6", "gelu", "sigmoid", "tanh", "softmax",
           "log_softmax", "silu", "swish", "hardswish", "hardsigmoid",
           "leaky_relu", "elu", "celu", "selu", "softplus", "softsign",
           "hardtanh", "mish", "tanhshrink", "hardshrink", "softshrink",
           "thresholded_relu", "log_sigmoid"]


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return torch.clamp(x, 0, 6)


def gelu(x, approximate=False, name=None):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def _dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    dtype = _dtype(dtype)
    return torch.softmax(x if dtype is None else x.to(dtype), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    dtype = _dtype(dtype)
    return torch.log_softmax(x if dtype is None else x.to(dtype), dim=axis)


def silu(x, name=None):
    return TF.silu(x)


swish = silu


def hardswish(x, name=None):
    return TF.hardswish(x)


def hardsigmoid(x, slope=1.0 / 6, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0, 1)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    return TF.elu(x, alpha)


def celu(x, alpha=1.0, name=None):
    return TF.celu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def softplus(x, beta=1, threshold=20, name=None):
    return TF.softplus(x, beta, threshold)


def softsign(x, name=None):
    return TF.softsign(x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def mish(x, name=None):
    return TF.mish(x)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def hardshrink(x, threshold=0.5, name=None):
    return TF.hardshrink(x, threshold)


def softshrink(x, threshold=0.5, name=None):
    return TF.softshrink(x, threshold)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def log_sigmoid(x, name=None):
    return TF.logsigmoid(x)
