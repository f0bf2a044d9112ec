"""Convolutions with Paddle's arguments, PyTorch port.

Counterpart of `paddle_tpu/nn/functional/conv.py` (`_conv` and
`_conv_transpose` over `lax.conv_general_dilated`): `conv1d` / `conv2d` /
`conv3d` and their transposes. The weights keep Paddle's layouts, which
are torch's own: ``[out, in / groups, *k]`` for a convolution and ``[in,
out / groups, *k]`` for a transpose. The work is torch's convolution
(cuDNN on the card), as the reference leaves it to XLA.

Paddle's padding forms:

- an int, or one int a spatial dim: the same pad on both sides;
- ``2n`` ints: ``(lo, hi)`` a spatial dim;
- ``n + 2`` pairs, the batch and channel dims' ``[0, 0]`` included, in
  the order of `data_format` (the reference reads ``padding[2:]`` for
  every layout, and its 2-D check for ``2n`` entries takes a list of four
  pairs first: ROADMAP.md Queue 3 logs both; the port reads the pairs of
  the spatial dims);
- ``"SAME"``: ``ceil(in / stride)`` outputs, the pad split with the odd
  element high, as `lax.padtype_to_pads` splits it (torch's
  ``padding="same"`` refuses a stride above 1); ``"VALID"``: none.

An asymmetric pad goes through `F.pad` before the convolution; a
symmetric one is the convolution's own. ``data_format`` ``"NLC"`` /
``"NHWC"`` / ``"NDHWC"`` is a logical layout: the input is viewed as
channel-first (a permutation, so a contiguous channel-last tensor is a
``channels_last`` one to cuDNN) and the output viewed back.

A transpose's explicit pad ``(lo, hi)`` and ``output_padding`` give
``(in - 1) stride - lo - hi + d (k - 1) + 1 + output_padding`` outputs, as
the reference's gradient-of-conv padding does; string padding is the
reference's too (lax refuses it with a stride above 1, and so does the
port). ``output_size`` crops the result to that size, as the reference's
does.

Under `amp.auto_cast` each call is one op to the policy (``conv1d``,
``conv2d``, ``conv3d``, ``conv2d_transpose``; the reference names the 1-D
and 3-D transposes by their own names, which are on no list): the inputs
are cast at the entry and the body runs under `amp.suspended()`.
"""
from __future__ import annotations

import torch.nn.functional as TF

from ... import amp

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CHANNEL_LAST = ("NLC", "NWC", "NHWC", "NDHWC")
_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _ntuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    return v * n if len(v) == 1 else v


def _pairs(padding, n, channel_last):
    """Paddle's explicit padding as ``[(lo, hi)] * n``, or the string
    ``"SAME"`` / ``"VALID"``."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        return mode
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if padding and all(isinstance(p, (list, tuple)) for p in padding):
        if len(padding) == n + 2:
            padding = padding[1:-1] if channel_last else padding[2:]
        if len(padding) != n:
            raise ValueError(f"{len(padding)} pairs of padding for {n} "
                             f"spatial dims")
        return [(int(lo), int(hi)) for lo, hi in padding]
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"padding {padding!r} fits none of Paddle's forms for "
                     f"{n} spatial dims")


def _same_pads(sizes, kernel, stride, dilation):
    """`lax.padtype_to_pads`' SAME: ceil(in / stride) outputs."""
    pads = []
    for size, k, s, d in zip(sizes, kernel, stride, dilation):
        k_eff = d * (k - 1) + 1
        out = -(-size // s)
        total = max((out - 1) * s + k_eff - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _torch_pad(pads):
    """``[(lo, hi)]`` a spatial dim in `F.pad`'s order (last dim first)."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _channel_first(x, channel_last):
    return x.movedim(-1, 1) if channel_last else x


def _restore(out, channel_last):
    return out.movedim(1, -1) if channel_last else out


def _cast(op_name, x, weight, bias):
    tensors = [x, weight] + ([bias] if bias is not None else [])
    tensors = amp.amp_cast_inputs(op_name, tensors)
    return tensors[0], tensors[1], (tensors[2] if bias is not None else None)


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format, n,
          op_name):
    channel_last = data_format in _CHANNEL_LAST
    x, weight, bias = _cast(op_name, x, weight, bias)
    with amp.suspended():
        stride = _ntuple(stride, n)
        dilation = _ntuple(dilation, n)
        v = _channel_first(x, channel_last)
        pads = _pairs(padding, n, channel_last)
        if pads == "VALID":
            pads = [(0, 0)] * n
        elif pads == "SAME":
            pads = _same_pads(v.shape[2:], weight.shape[2:], stride, dilation)
        if all(lo == hi for lo, hi in pads):
            sym = tuple(lo for lo, _ in pads)
        else:
            v = TF.pad(v, _torch_pad(pads))
            sym = (0,) * n
        out = _CONV[n](v, weight, bias, stride, sym, dilation, groups)
        return _restore(out, channel_last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 1, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3, "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, n, op_name,
                    output_size=None):
    channel_last = data_format in _CHANNEL_LAST
    x, weight, bias = _cast(op_name, x, weight, bias)
    with amp.suspended():
        stride = _ntuple(stride, n)
        dilation = _ntuple(dilation, n)
        out_pad = _ntuple(output_padding, n) if output_padding else (0,) * n
        v = _channel_first(x, channel_last)
        pads = _pairs(padding, n, channel_last)
        k_eff = [d * (k - 1) + 1 for k, d in zip(weight.shape[2:], dilation)]
        if isinstance(pads, str):
            if any(s != 1 for s in stride):
                raise ValueError(
                    f"{op_name}: string padding with a stride above 1 is not "
                    f"defined for a transposed convolution (the reference's "
                    f"lax.conv_general_dilated refuses it too); give the "
                    f"padding explicitly")
            # lax's pads on the input of the flipped kernel, as a
            # transpose's (lo, hi); output_padding does not apply
            lax_pads = [(0, 0)] * n if pads == "VALID" else \
                _same_pads(v.shape[2:], weight.shape[2:], stride, dilation)
            pads = [(k - 1 - lo, k - 1 - hi)
                    for k, (lo, hi) in zip(k_eff, lax_pads)]
            out_pad = (0,) * n
        native = all(lo == hi and lo >= 0 for lo, hi in pads) and all(
            op < max(s, d) for op, s, d in zip(out_pad, stride, dilation))
        if native:
            out = _CONV_T[n](v, weight, bias, stride,
                             tuple(lo for lo, _ in pads), out_pad, groups,
                             dilation)
        else:
            # the full transpose, then crop lo and hi - output_padding (a
            # negative pad of F.pad crops); the bias after, so that
            # positions past the full output hold it alone, as the
            # reference's do
            out = _CONV_T[n](v, weight, None, stride, 0, 0, groups, dilation)
            out = TF.pad(out, _torch_pad([(-lo, op - hi) for (lo, hi), op
                                          in zip(pads, out_pad)]))
            if bias is not None:
                out = out + bias.reshape((1, -1) + (1,) * n)
        if output_size is not None:
            want = output_size if isinstance(output_size, (list, tuple)) \
                else [output_size] * n
            out = out[(slice(None), slice(None))
                      + tuple(slice(0, int(want[i])) for i in range(n))]
        return _restore(out, channel_last)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 1,
                           "conv1d_transpose", output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 2,
                           "conv2d_transpose", output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 3,
                           "conv3d_transpose", output_size)
