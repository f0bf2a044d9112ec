"""Geometric and video functionals, PyTorch port: `affine_grid`,
`grid_sample`, `temporal_shift` and `zeropad2d`.

Counterpart of `paddle_tpu/nn/functional/vision.py`, on the input's
device and differentiable by autograd. Semantics kept from the reference:

- `affine_grid` spaces its base grid as ``linspace(-1, 1, n)`` with
  ``align_corners`` (a size of 1 gives -1, where torch's `affine_grid`
  gives 0) and as pixel centres ``linspace(-1 + 1/n, 1 - 1/n, n)``
  without, then applies theta in float64, as the reference does under
  its x64 mode, and casts to theta's dtype (reference :23-57).
- `grid_sample` takes ``mode`` ``"bilinear"`` (trilinear on 5-D input)
  or ``"nearest"`` and ``padding_mode`` ``"zeros"``, ``"border"`` or
  ``"reflection"``; another value raises. Bilinear sampling is
  `torch.nn.functional.grid_sample`, which computes the reference's
  function: its corners are weighted by the fractional part and clipped
  or reflected (reference :60-72, :75-144; reflecting a coordinate and
  then its corners gives the same samples, since the reflection is
  affine between integers). Nearest sampling rounds half up,
  ``floor(c + 0.5)``, where torch rounds half to even, so it is a gather
  of its own: the rounded index reflected or clipped, zero outside the
  image under ``"zeros"`` (reference :108-113).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

__all__ = ["affine_grid", "grid_sample", "temporal_shift", "zeropad2d"]


def _line(n, align_corners, like):
    if align_corners:
        return torch.linspace(-1.0, 1.0, n, dtype=torch.float64,
                              device=like.device)
    step = 2.0 / n
    return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, n,
                          dtype=torch.float64, device=like.device)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """Sampling grid from batched affine matrices: theta [N, 2, 3] and
    out_shape [N, C, H, W] give [N, H, W, 2]; theta [N, 3, 4] and
    [N, C, D, H, W] give [N, D, H, W, 3]."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    out_shape = [int(s) for s in out_shape]
    lines = [_line(n, align_corners, theta) for n in out_shape[2:]]
    axes = torch.meshgrid(*lines, indexing="ij")        # (z,) y, x
    base = torch.stack([*reversed(axes), torch.ones_like(axes[0])], -1)
    if tuple(theta.shape[-2:]) == (2, 3):
        grid = torch.einsum("hwk,njk->nhwj", base, theta.double())
    else:
        grid = torch.einsum("dhwk,njk->ndhwj", base, theta.double())
    return grid.to(theta.dtype)


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(x, size, align_corners):
    if size == 1:
        return torch.zeros_like(x)
    if align_corners:
        span = 2.0 * (size - 1)
        x = torch.remainder(x.abs(), span)
        return torch.where(x > size - 1, span - x, x)
    span = 2.0 * size
    x = torch.remainder((x + 0.5).abs(), span)
    x = torch.where(x > size, span - x, x) - 0.5
    return x.clamp(0, size - 1)


def _grid_sample_nearest(x, grid, padding_mode, align_corners):
    n, c = x.shape[:2]
    spatial = x.shape[2:]
    dims = len(spatial)
    g = grid.float()
    flat, valid = None, None
    for d, size in enumerate(spatial):
        coord = torch.floor(_unnormalize(g[..., dims - 1 - d], size,
                                         align_corners) + 0.5)
        if padding_mode == "border":
            coord = coord.clamp(0, size - 1)
        elif padding_mode == "reflection":
            coord = _reflect(coord, size, align_corners)
        ok = (coord >= 0) & (coord <= size - 1)
        valid = ok if valid is None else valid & ok
        idx = coord.clamp(0, size - 1).long()
        flat = idx if flat is None else flat * size + idx
    out_spatial = flat.shape[1:]
    index = flat.reshape(n, 1, -1).expand(n, c, -1)
    out = torch.gather(x.reshape(n, c, -1), 2, index)
    out = out.reshape(n, c, *out_spatial)
    if padding_mode == "zeros":
        out = out * valid[:, None].to(x.dtype)
    return out


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample x at grid locations. 4-D: x [N, C, H, W], grid [N, Ho, Wo, 2]
    (the last axis (x, y) in [-1, 1]); 5-D: x [N, C, D, H, W], grid
    [N, Do, Ho, Wo, 3]."""
    if grid.shape[-1] not in (2, 3):
        raise ValueError("grid last dim must be 2 or 3")
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample mode must be 'bilinear' or "
                         f"'nearest', got {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"grid_sample padding_mode must be 'zeros', "
                         f"'border' or 'reflection', got {padding_mode!r}")
    if mode == "nearest":
        return _grid_sample_nearest(x, grid, padding_mode, align_corners)
    return TF.grid_sample(x, grid.to(x.dtype), mode="bilinear",
                          padding_mode=padding_mode,
                          align_corners=align_corners)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM channel shift: within each segment of seg_num frames, the first
    `shift_ratio` of channels take the previous frame, the next
    `shift_ratio` the following one; frames shifted in from outside the
    segment are zero."""
    nhwc = data_format == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1 = int(c * shift_ratio)
    c2 = int(c * 2 * shift_ratio)
    pad = torch.zeros_like(v[:, :1])
    prev = torch.cat([pad, v[:, :-1]], 1)          # out[t] = x[t-1]
    nxt = torch.cat([v[:, 1:], pad], 1)            # out[t] = x[t+1]
    out = torch.cat([prev[:, :, :c1], nxt[:, :, c1:c2], v[:, :, c2:]], 2)
    out = out.reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if nhwc else out


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero-pad the two spatial axes; padding = [left, right, top,
    bottom]."""
    left, right, top, bottom = [int(p) for p in padding]
    if data_format == "NCHW":
        return TF.pad(x, (left, right, top, bottom))
    return TF.pad(x, (0, 0, left, right, top, bottom))
