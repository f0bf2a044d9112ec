"""Dropout and channel shuffle with Paddle's arguments, PyTorch port.

Counterpart of part of `paddle_tpu/nn/functional/common.py`: `dropout`
(``mode`` ``"upscale_in_train"``, the default, scales the kept elements
by ``1 / (1 − p)`` in training; ``"downscale_in_infer"`` keeps them as
they are and scales by ``1 − p`` outside training; ``axis`` draws one
mask element for each index of those axes, broadcast over the others)
and `channel_shuffle`. The masks are torch's draws, not `jax.random`'s:
parity tests hold a dropout to its rule, not to the reference's bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

__all__ = ["dropout", "channel_shuffle"]


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be upscale_in_train or "
                         f"downscale_in_infer, got {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if axis is None and mode == "upscale_in_train":
        return TF.dropout(x, p, training=True)
    axes = [] if axis is None else \
        list(axis) if isinstance(axis, (list, tuple)) else [axis]
    axes = [a % x.ndim for a in axes]
    shape = [s if not axes or i in axes else 1 for i, s in enumerate(x.shape)]
    keep = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(1 - p)
    if mode == "upscale_in_train":
        return x * keep / (1.0 - p)
    return x * keep


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
        .reshape(n, h, w, c)
