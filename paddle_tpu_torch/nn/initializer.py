"""Weight initializers, PyTorch port.

Counterpart of `paddle_tpu/nn/initializer.py` (`Constant`, `Uniform`,
`TruncatedNormal`, `XavierNormal`, `XavierUniform` and `_compute_fans`),
the ones the transformer layers and ViT name. Each is a callable that
fills a tensor in place, as `torch.nn.init`'s functions do:
``init(tensor, generator=None)``. Values are drawn in fp32 on the tensor's
device, from `generator` (a `torch.Generator` on that device) or from
torch's default generator, then cast to the tensor's dtype, as the
reference draws in fp32 and casts. The draws are torch's, not
`jax.random`'s bits: parity tests carry weights across with `convert`.

Fans follow the reference's rule, not torch's: a 2-D shape reads as
``[in, out]`` (Paddle's Linear layout), a shape of rank > 2 as
``[out, in, *receptive]`` with fan_in = shape[1] · receptive and fan_out =
shape[0] · receptive; so the fused qkv weight ``[3, H, D, E]`` has fan_in
H·D·E and fan_out 3·D·E. torch's own rule reads a 2-D weight as ``[out,
in]``; Xavier's sum of fans is the same either way.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Initializer", "Constant", "Uniform", "TruncatedNormal",
           "XavierNormal", "XavierUniform", "compute_fans", "from_attr"]


def compute_fans(shape):
    """(fan_in, fan_out) of `shape` by the reference's `_compute_fans`."""
    shape = [int(s) for s in shape]
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """Fills `tensor` in place (under no_grad) and returns it."""

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            value = self._draw(tuple(tensor.shape), tensor.device, generator)
            return tensor.copy_(value)

    def _draw(self, shape, device, generator):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _draw(self, shape, device, generator):
        return torch.full(shape, float(self.value), dtype=torch.float32,
                          device=device)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low = low
        self.high = high

    def _draw(self, shape, device, generator):
        out = torch.empty(shape, dtype=torch.float32, device=device)
        return out.uniform_(self.low, self.high, generator=generator)


class TruncatedNormal(Initializer):
    """mean + std · N(0, 1) truncated to ±2, that is to ±2 std about the
    mean, as the reference's ``truncated_normal(-2, 2)``. (torch's
    `trunc_normal_` takes absolute bounds, ±2 by default, which do not
    truncate a std of 0.02 at all; the bounds here are mean ± 2 std.)"""

    def __init__(self, mean=0.0, std=1.0):
        self.mean = mean
        self.std = std

    def _draw(self, shape, device, generator):
        out = torch.empty(shape, dtype=torch.float32, device=device)
        return torch.nn.init.trunc_normal_(
            out, self.mean, self.std, a=self.mean - 2.0 * self.std,
            b=self.mean + 2.0 * self.std, generator=generator)


class _Xavier(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in = fan_in
        self._fan_out = fan_out
        self.gain = gain

    def _fans(self, shape):
        fi, fo = compute_fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        return fi, fo


class XavierNormal(_Xavier):
    """N(0, gain² · 2 / (fan_in + fan_out))."""

    def _draw(self, shape, device, generator):
        fi, fo = self._fans(shape)
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        out = torch.empty(shape, dtype=torch.float32, device=device)
        return out.normal_(0.0, std, generator=generator)


class XavierUniform(_Xavier):
    """U(-l, l) with l = gain · sqrt(6 / (fan_in + fan_out))."""

    def _draw(self, shape, device, generator):
        fi, fo = self._fans(shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        out = torch.empty(shape, dtype=torch.float32, device=device)
        return out.uniform_(-limit, limit, generator=generator)


def from_attr(attr, default):
    """The initializer a layer's ``*_attr`` argument names: `default` for
    None, the attr itself for an `Initializer`. (The reference's attrs are
    `ParamAttr`s, which the port has not ported; ``False``, no parameter,
    is the caller's to handle.) Raises TypeError on anything else."""
    if attr is None:
        return default
    if isinstance(attr, Initializer):
        return attr
    raise TypeError(f"a parameter attr must be None or an Initializer of "
                    f"paddle_tpu_torch.nn.initializer, got {attr!r}")
