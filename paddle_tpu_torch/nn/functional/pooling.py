"""Pooling with Paddle's arguments, PyTorch port.

Counterpart of `paddle_tpu/nn/functional/pooling.py` (`_pool` over
`lax.reduce_window`, `_max_pool_mask`, `_adaptive_pool`, `_max_unpool`):
max and average pools in 1-D, 2-D and 3-D, their adaptive forms and
`max_unpool*`. The work is torch's pooling, as the reference leaves it to
XLA; where torch's rules differ from the reference's, the port pads
explicitly and pools without torch's padding:

- A padded window counts only the input's elements (``exclusive=True``,
  the default, torch's ``count_include_pad=False``); ``exclusive=False``
  divides by the whole kernel, and so does ``"SAME"`` padding, whose pad
  the reference never counts (it keeps no explicit pads there,
  reference :73).
- ``ceil_mode`` adds to the high pad what a last, partial window needs
  (reference :58-66). torch drops a last window that starts in the
  padding, the reference keeps it, so ``ceil_mode`` always pads
  explicitly here. A max pool pads with -inf, an average pool with 0
  (its count with 0 too).
- torch's pools refuse a pad above half the kernel; such pads go through
  the explicit route too.

``return_mask`` gives each output the flat index of its maximum in its
input plane (``h * W + w``), the first maximum on ties, over the pad of
``padding`` without the ``ceil_mode`` extension and with no pad for a
string, as the reference's mask is taken. The adaptive pools' windows are
``floor(j in / out)`` to ``ceil((j + 1) in / out)``, torch's and the
reference's. ``data_format`` ``"NHWC"`` / ``"NDHWC"`` is a logical layout
(the input viewed channel-first, the output viewed back).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

__all__ = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
           "max_unpool1d", "max_unpool2d", "max_unpool3d"]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE_AVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
                 3: TF.adaptive_avg_pool3d}
_ADAPTIVE_MAX = {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
                 3: TF.adaptive_max_pool3d}
_UNPOOL = {1: TF.max_unpool1d, 2: TF.max_unpool2d, 3: TF.max_unpool3d}


def _norm(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    return v * n if len(v) == 1 else v


def _channel_first(x, channel_last):
    return x.movedim(-1, 1) if channel_last else x


def _restore(out, channel_last):
    return out.movedim(1, -1) if channel_last else out


def _torch_pad(pads):
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _window_pads(sizes, kernel, stride, padding, ceil_mode):
    """The reference's pads ``[(lo, hi)]`` a spatial dim (SAME as
    `lax.padtype_to_pads`, ceil_mode's extension on the high side), and
    whether they are counted as explicit pads (not for a string)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * len(sizes), False
        pads = []
        for size, k, s in zip(sizes, kernel, stride):
            out = -(-size // s)
            total = max((out - 1) * s + k - size, 0)
            pads.append((total // 2, total - total // 2))
        return pads, False
    p = _norm(padding, len(sizes))
    pads = [(pi, pi) for pi in p]
    if ceil_mode:
        for i, (size, k, s) in enumerate(zip(sizes, kernel, stride)):
            lo, hi = pads[i]
            out_c = math.ceil((size + lo + hi - k) / s + 1)
            need = (out_c - 1) * s + k - (size + lo + hi)
            pads[i] = (lo, hi + max(need, 0))
    return pads, True


def _native(pads, kernel):
    """Whether torch's own symmetric padding pools the same windows."""
    return all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel))


def _pool(x, kernel, stride, padding, n, is_avg, exclusive=True,
          ceil_mode=False, channel_last=False):
    kernel = _norm(kernel, n)
    stride = _norm(stride if stride is not None else kernel, n)
    v = _channel_first(x, channel_last)
    pads, explicit = _window_pads(v.shape[2:], kernel, stride, padding,
                                  ceil_mode)
    if not is_avg:
        if _native(pads, kernel):
            out = _MAX[n](v, kernel, stride, tuple(lo for lo, _ in pads))
        else:
            out = _MAX[n](TF.pad(v, _torch_pad(pads), value=-math.inf),
                          kernel, stride)
        return _restore(out, channel_last)
    # the whole kernel divides, or only the input's elements in a window
    whole = not (exclusive and explicit)
    if _native(pads, kernel):
        # without ceil_mode every window of torch's lies in the padded
        # input, so counting the pad is dividing by the whole kernel
        out = _AVG[n](v, kernel, stride, tuple(lo for lo, _ in pads),
                      count_include_pad=whole)
        return _restore(out, channel_last)
    flat = _torch_pad(pads)
    total = _AVG[n](TF.pad(v, flat), kernel, stride)
    if not whole:
        ones = torch.ones((1, 1) + tuple(v.shape[2:]), dtype=v.dtype,
                          device=v.device)
        total = total / _AVG[n](TF.pad(ones, flat), kernel, stride)
    return _restore(total, channel_last)


def _windows(t, kernel, stride):
    """``[..., *out, prod(kernel)]``: every window of the spatial dims."""
    n = len(kernel)
    for i in range(n):
        t = t.unfold(2 + i, kernel[i], stride[i])
    return t.flatten(-n)


def _max_pool_mask(x, kernel, stride, padding, n, channel_last):
    kernel = _norm(kernel, n)
    stride = _norm(stride if stride is not None else kernel, n)
    p = _norm(padding if not isinstance(padding, str) else 0, n)
    v = _channel_first(x, channel_last)
    spatial = tuple(v.shape[2:])
    flat = _torch_pad([(pi, pi) for pi in p])
    index = torch.arange(math.prod(spatial), device=v.device).reshape(
        (1, 1) + spatial)
    vals = _windows(TF.pad(v, flat, value=-math.inf), kernel, stride)
    where = _windows(TF.pad(index, flat), kernel, stride)
    # argmax takes the first maximum; a window's pad is -inf and never one
    first = vals.argmax(-1, keepdim=True)
    mask = torch.gather(where.expand(vals.shape), -1, first).squeeze(-1)
    return _restore(mask, channel_last)


def _max(x, kernel_size, stride, padding, return_mask, ceil_mode, n,
         channel_last):
    out = _pool(x, kernel_size, stride, padding, n, False,
                ceil_mode=ceil_mode, channel_last=channel_last)
    if return_mask:
        return out, _max_pool_mask(x, kernel_size, stride, padding, n,
                                   channel_last)
    return out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _max(x, kernel_size, stride, padding, return_mask, ceil_mode, 1,
                False)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max(x, kernel_size, stride, padding, return_mask, ceil_mode, 2,
                data_format == "NHWC")


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max(x, kernel_size, stride, padding, return_mask, ceil_mode, 3,
                data_format == "NDHWC")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, True, exclusive,
                 ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    channel_last = data_format == "NHWC"
    if divisor_override:
        # the reference's: the window sums (ceil_mode and exclusive are
        # not read), over the divisor
        kernel = _norm(kernel_size, 2)
        total = _pool(x, kernel_size, stride, padding, 2, True, False,
                      channel_last=channel_last) * math.prod(kernel)
        return total * (1.0 / divisor_override)
    return _pool(x, kernel_size, stride, padding, 2, True, exclusive,
                 ceil_mode, channel_last)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    # the reference takes divisor_override and does not read it
    return _pool(x, kernel_size, stride, padding, 3, True, exclusive,
                 ceil_mode, data_format == "NDHWC")


def _adaptive(x, output_size, n, is_avg, channel_last, return_mask=False):
    v = _channel_first(x, channel_last)
    if isinstance(output_size, int):
        output_size = (output_size,) * n
    output_size = tuple(s if o is None else int(o)
                        for o, s in zip(output_size, v.shape[2:]))
    if is_avg:
        return _restore(_ADAPTIVE_AVG[n](v, output_size), channel_last)
    out, mask = _ADAPTIVE_MAX[n](v, output_size, return_indices=True)
    out = _restore(out, channel_last)
    return (out, _restore(mask, channel_last)) if return_mask else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, True, False)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, True, data_format == "NHWC")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, True, data_format == "NDHWC")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, False, False, return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, False, False, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, False, False, return_mask)


def _max_unpool(x, indices, kernel_size, stride, padding, n, output_size,
                channel_last, op_name):
    """Each pooled value at its recorded flat index of the output plane
    (the reference's `_max_unpool`: ``(in - 1) stride - 2 pad + kernel``
    outputs a dim unless `output_size` says)."""
    if channel_last:
        raise NotImplementedError(f"{op_name}: a channel-last unpool is not "
                                  f"supported (nor is it by the reference)")
    kernel = _norm(kernel_size, n)
    stride = _norm(stride if stride is not None else kernel_size, n)
    p = _norm(padding, n)
    if output_size is None:
        out = tuple((x.shape[2 + i] - 1) * stride[i] - 2 * p[i] + kernel[i]
                    for i in range(n))
    else:
        out = tuple(int(s) for s in tuple(output_size)[-n:])
    flat_v = x.reshape(x.shape[0] * x.shape[1], -1)
    flat_i = indices.reshape(flat_v.shape).long()
    plane = flat_v.new_zeros((flat_v.shape[0], math.prod(out)))
    plane.scatter_(1, flat_i, flat_v)
    return plane.reshape(tuple(x.shape[:2]) + out)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 1,
                       output_size, data_format == "NLC", "max_unpool1d")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 2,
                       output_size, data_format == "NHWC", "max_unpool2d")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 3,
                       output_size, data_format == "NDHWC", "max_unpool3d")
