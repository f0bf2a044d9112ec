"""Batch, instance, group and local-response normalization, PyTorch port.

Counterpart of `paddle_tpu/nn/functional/norm.py` (`batch_norm`,
`instance_norm`, `group_norm`, `local_response_norm`), with the
reference's semantics:

- `batch_norm` in training (and not ``use_global_stats``) normalizes by
  the batch's statistics, computed in fp32, with the biased variance, and
  moves the running statistics in place: ``running = momentum · running
  + (1 − momentum) · batch`` (Paddle's momentum, 0.9 by default), the
  variance unbiased (``n / (n − 1)``). Otherwise it normalizes by the
  running statistics and moves nothing. ``data_format`` ending in ``C``
  (``NHWC``, ``NLC``, ``NDHWC``) puts the channels last.
- An fp32 input with fp32 affine parameters takes `F.batch_norm` (cuDNN
  on the card; its momentum is ``1 − momentum``), which rounds once. Any
  other input takes the reference's order: normalize in fp32, round to
  the input's dtype, then the weight and the bias (whose fp32 values
  promote a bf16 result to fp32, as JAX's do).
- `instance_norm` normalizes each (sample, channel) over its spatial dims
  and reads neither running statistics nor ``data_format``, as the
  reference's does; `group_norm` normalizes each group of channels of a
  sample in fp32; `local_response_norm` divides by ``(k + alpha · Σ x²) **
  beta`` over ``size`` neighbouring channels (alpha not divided by size,
  unlike torch's).

Under `amp.auto_cast` each is one op to the policy, under the reference's
names (``batch_norm``, ``instance_norm`` and ``group_norm`` are on the
black list: their inputs go to fp32): inputs cast at the entry, the body
under `amp.suspended()`. A training `batch_norm` hands the policy
``[x, weight, bias]`` and an evaluating one ``[x, mean, variance, weight,
bias]``, as the reference's op takes them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp

__all__ = ["batch_norm", "instance_norm", "group_norm",
           "local_response_norm"]


def _channel_last(data_format, ndim):
    return ndim > 2 and data_format.endswith("C") and data_format != "NCHW"


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def _present(*tensors):
    return [t for t in tensors if t is not None]


def _unpack(cast, weight, bias):
    """The cast weight and bias back out of the tail of `cast`."""
    tail = list(cast)
    b = tail.pop() if bias is not None else None
    w = tail.pop() if weight is not None else None
    return w, b


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    batch_stats = training and not use_global_stats
    stats = [] if batch_stats else [running_mean, running_var]
    cast = amp.amp_cast_inputs(
        "batch_norm", [x] + stats + _present(weight, bias))
    x = cast[0]
    weight, bias = _unpack(cast, weight, bias)
    if not batch_stats:
        running_mean, running_var = cast[1], cast[2]
    with amp.suspended():
        channel_last = _channel_last(data_format, x.ndim)
        v = x.movedim(-1, 1) if channel_last else x
        fp32 = torch.float32
        if v.dtype == fp32 and all(t.dtype == fp32
                                   for t in _present(weight, bias)):
            out = TF.batch_norm(v, running_mean, running_var, weight, bias,
                                training=batch_stats, momentum=1 - momentum,
                                eps=epsilon)
        else:
            out = _batch_norm_rounded(v, running_mean, running_var, weight,
                                      bias, batch_stats, momentum, epsilon)
        return out.movedim(1, -1) if channel_last else out


def _batch_norm_rounded(v, running_mean, running_var, weight, bias,
                        batch_stats, momentum, epsilon):
    """The reference's order for an input that is not fp32 (``v`` is
    channel-first)."""
    shape = [1] * v.ndim
    shape[1] = v.shape[1]
    axes = [i for i in range(v.ndim) if i != 1]
    vf = v.float()
    if batch_stats:
        mean = vf.mean(axes)
        var = vf.var(axes, correction=0)
        with torch.no_grad():
            n = v.numel() // v.shape[1]
            if running_mean is not None:
                running_mean.copy_(momentum * running_mean.float()
                                   + (1 - momentum) * mean)
            if running_var is not None:
                unbiased = var * (n / max(n - 1, 1))
                running_var.copy_(momentum * running_var.float()
                                  + (1 - momentum) * unbiased)
    else:
        mean, var = running_mean.float(), running_var.float()
    out = ((vf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                    + epsilon)).to(v.dtype)
    return _affine(out, weight, bias, shape)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    cast = amp.amp_cast_inputs("instance_norm", [x] + _present(weight, bias))
    x = cast[0]
    weight, bias = _unpack(cast, weight, bias)
    with amp.suspended():
        shape = [1] * x.ndim
        shape[1] = x.shape[1]
        axes = list(range(2, x.ndim))
        vf = x.float()
        mean = vf.mean(axes, keepdim=True)
        var = vf.var(axes, keepdim=True, correction=0)
        out = ((vf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
        return _affine(out, weight, bias, shape)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    cast = amp.amp_cast_inputs("group_norm", [x] + _present(weight, bias))
    x = cast[0]
    weight, bias = _unpack(cast, weight, bias)
    with amp.suspended():
        channel_last = _channel_last(data_format, x.ndim)
        v = x.movedim(-1, 1) if channel_last else x
        c = v.shape[1]
        grouped = v.reshape((v.shape[0], num_groups, c // num_groups)
                            + tuple(v.shape[2:])).float()
        axes = list(range(2, grouped.ndim))
        mean = grouped.mean(axes, keepdim=True)
        var = grouped.var(axes, keepdim=True, correction=0)
        out = ((grouped - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
        out = out.reshape(v.shape)
        if channel_last:
            out = out.movedim(1, -1)
        shape = [1] * x.ndim
        shape[-1 if channel_last else 1] = c
        return _affine(out, weight, bias, shape)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    c = x.shape[1]
    half = size // 2
    sq = x * x
    pad_shape = list(x.shape)
    pieces = []
    for width in (half, size - half - 1):
        pad_shape[1] = width
        pieces.append(sq.new_zeros(pad_shape))
    padded = torch.cat([pieces[0], sq, pieces[1]], dim=1)
    acc = padded.narrow(1, 0, c)
    for i in range(1, size):
        acc = acc + padded.narrow(1, i, c)
    return x / torch.pow(k + alpha * acc, beta)
