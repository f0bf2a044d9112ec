"""Image-transform functionals, PyTorch port: colour, crops, padding,
erasing and geometric warps.

Counterpart of `paddle_tpu/vision/transforms/functional.py`, whose numpy
code this module copies. Images are HWC (uint8 or float) or CHW numpy
arrays or torch tensors, as in the reference's cv2 backend; a torch tensor
comes back as a float32 tensor on the CPU, an array as an array. The
warps (rotate, affine, perspective) sample through the port's own
`nn.functional.grid_sample`, as the reference's go through its own.
"""
from __future__ import annotations

import math
import numbers

import numpy as np
import torch

__all__ = ["adjust_brightness", "adjust_contrast", "adjust_hue",
           "adjust_saturation", "to_grayscale", "crop", "center_crop",
           "pad", "erase", "rotate", "affine", "perspective"]


def _to_numpy(img):
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def _tensor(arr):
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32))


def _wrap_like(img, arr, clip_max=None):
    src = _to_numpy(img)
    if src.dtype == np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    elif clip_max is not None:
        arr = np.clip(arr, 0, clip_max)
    if isinstance(img, torch.Tensor):
        return _tensor(arr)
    return arr


def _is_channel_last(arr):
    return arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] in (1, 3, 4))


def _hw(arr):
    if _is_channel_last(arr):
        return arr.shape[0], arr.shape[1]
    return arr.shape[1], arr.shape[2]


# ---------- color ----------

def adjust_brightness(img, brightness_factor):
    arr = _to_numpy(img).astype(np.float32)
    return _wrap_like(img, arr * brightness_factor)


def to_grayscale(img, num_output_channels=1):
    """Rec.601 luma (reference functional_cv2.to_grayscale via cv2)."""
    arr = _to_numpy(img).astype(np.float32)
    cl = _is_channel_last(arr)
    if arr.ndim == 2:
        g = arr
    elif cl:
        g = arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114
    else:
        g = arr[0] * 0.299 + arr[1] * 0.587 + arr[2] * 0.114
    if num_output_channels == 3:
        g = np.stack([g] * 3, axis=-1 if cl or arr.ndim == 2 else 0)
    elif arr.ndim == 3:
        g = np.expand_dims(g, -1 if cl else 0)
    return _wrap_like(img, g)


def adjust_contrast(img, contrast_factor):
    arr = _to_numpy(img).astype(np.float32)
    gray = _to_numpy(to_grayscale(img)).astype(np.float32)
    mean = gray.mean()
    return _wrap_like(img, (arr - mean) * contrast_factor + mean)


def adjust_saturation(img, saturation_factor):
    arr = _to_numpy(img).astype(np.float32)
    gray = _to_numpy(to_grayscale(img, num_output_channels=3)) \
        .astype(np.float32)
    if gray.shape != arr.shape:
        gray = np.broadcast_to(gray, arr.shape)
    return _wrap_like(img,
                      arr * saturation_factor + gray * (1 - saturation_factor))


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    rc = np.where(delta > 0, (maxc - r) / np.maximum(delta, 1e-12), 0.0)
    gc = np.where(delta > 0, (maxc - g) / np.maximum(delta, 1e-12), 0.0)
    bc = np.where(delta > 0, (maxc - b) / np.maximum(delta, 1e-12), 0.0)
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    conds = [i == k for k in range(6)]
    r = np.select(conds, [v, q, p, p, t, v])
    g = np.select(conds, [t, v, v, q, p, p])
    b = np.select(conds, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def adjust_hue(img, hue_factor):
    """Cyclic hue shift via RGB→HSV→RGB (reference functional_cv2:387)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError(f"hue_factor {hue_factor} not in [-0.5, 0.5]")
    arr = _to_numpy(img).astype(np.float32)
    cl = _is_channel_last(arr)
    hwc = arr if cl else np.moveaxis(arr, 0, -1)
    scale = 255.0 if _to_numpy(img).dtype == np.uint8 or hwc.max() > 1.5 \
        else 1.0
    hsv = _rgb_to_hsv(hwc / scale)
    hsv[..., 0] = (hsv[..., 0] + hue_factor) % 1.0
    out = _hsv_to_rgb(hsv) * scale
    if not cl:
        out = np.moveaxis(out, -1, 0)
    return _wrap_like(img, out)


# ---------- crops / pad / erase ----------

def crop(img, top, left, height, width):
    arr = _to_numpy(img)
    if _is_channel_last(arr):
        out = arr[top:top + height, left:left + width]
    else:
        out = arr[:, top:top + height, left:left + width]
    return _tensor(out) if isinstance(img, torch.Tensor) else out


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    arr = _to_numpy(img)
    h, w = _hw(arr)
    th, tw = output_size
    return crop(img, max((h - th) // 2, 0), max((w - tw) // 2, 0), th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    arr = _to_numpy(img)
    if isinstance(padding, numbers.Number):
        l = t = r = b = int(padding)
    elif len(padding) == 2:
        l, t = padding
        r, b = padding
    else:
        l, t, r, b = padding
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    if _is_channel_last(arr):
        cfg = ((t, b), (l, r)) + (((0, 0),) if arr.ndim == 3 else ())
    else:
        cfg = ((0, 0), (t, b), (l, r))
    out = np.pad(arr, cfg, mode=mode, **kw)
    return _tensor(out) if isinstance(img, torch.Tensor) else out


def erase(img, i, j, h, w, v, inplace=False):
    """Fill region [i:i+h, j:j+w] with v (reference: functional.erase)."""
    is_tensor = isinstance(img, torch.Tensor)
    arr = _to_numpy(img)
    out = arr if inplace and not is_tensor else arr.copy()
    vv = np.asarray(_to_numpy(v), out.dtype)
    if _is_channel_last(arr):
        out[i:i + h, j:j + w] = vv
    else:
        out[:, i:i + h, j:j + w] = vv
    if is_tensor:
        res = _tensor(out)
        if inplace:
            with torch.no_grad():
                img.copy_(res)
            return img
        return res
    return out


# ---------- geometric warps (through the framework's grid_sample) ----------

def _warp(img, inv_mat, out_hw, interpolation, fill):
    """Inverse-warp `img` with the 3x3 pixel-space matrix `inv_mat`
    (output pixel -> input pixel), sampling via nn.functional.grid_sample."""
    from ...nn.functional.vision import grid_sample
    arr = _to_numpy(img)
    cl = _is_channel_last(arr)
    chw = arr if not cl else (
        arr[None] if arr.ndim == 2 else np.moveaxis(arr, -1, 0))
    chw = chw.astype(np.float32)
    C, H, W = chw.shape
    oh, ow = out_hw
    ys, xs = np.meshgrid(np.arange(oh, dtype=np.float32),
                         np.arange(ow, dtype=np.float32), indexing="ij")
    ones = np.ones_like(xs)
    pts = np.stack([xs, ys, ones], -1).reshape(-1, 3) @ inv_mat.T
    sx = pts[:, 0] / np.maximum(np.abs(pts[:, 2]), 1e-9) * np.sign(pts[:, 2])
    sy = pts[:, 1] / np.maximum(np.abs(pts[:, 2]), 1e-9) * np.sign(pts[:, 2])
    # normalize to [-1, 1] with align_corners=True convention
    gx = 2.0 * sx / max(W - 1, 1) - 1.0
    gy = 2.0 * sy / max(H - 1, 1) - 1.0
    grid = np.stack([gx, gy], -1).reshape(1, oh, ow, 2).astype(np.float32)
    mode = "nearest" if interpolation == "nearest" else "bilinear"
    grid = torch.from_numpy(grid)
    out = grid_sample(_tensor(chw[None]), grid, mode=mode,
                      padding_mode="zeros", align_corners=True).numpy()[0]
    if fill:
        mask = grid_sample(torch.ones((1, 1, H, W)), grid, mode=mode,
                           padding_mode="zeros",
                           align_corners=True).numpy()[0, 0]
        out = out * mask + np.float32(fill) * (1.0 - mask)
    if cl:
        out = out[0] if arr.ndim == 2 else np.moveaxis(out, 0, -1)
    return _wrap_like(img, out)


def _inverse_affine_matrix(center, angle, translate, scale, shear):
    """Pixel-space inverse affine (same parameterization as the
    reference/torchvision): rotation+shear+scale about `center`, then
    translation."""
    rot = math.radians(angle)
    sx, sy = [math.radians(s) for s in shear]
    cx, cy = center
    tx, ty = translate
    # forward: M = T(c) T(t) R(rot) Sh(sx, sy) S(scale) T(-c)
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    # inverse of scale * [a b; c d]
    det = scale * (a * d - b * c)
    ia, ib, ic, id_ = d / det * scale, -b / det * scale, \
        -c / det * scale, a / det * scale
    # inv translation: -inv(M) @ (c + t) + c
    m02 = cx - ia * (cx + tx) - ib * (cy + ty)
    m12 = cy - ic * (cx + tx) - id_ * (cy + ty)
    return np.array([[ia, ib, m02], [ic, id_, m12], [0, 0, 1]], np.float32)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    arr = _to_numpy(img)
    h, w = _hw(arr)
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    if expand:
        rot = math.radians(angle)
        cos_a, sin_a = abs(math.cos(rot)), abs(math.sin(rot))
        ow = int(round(w * cos_a + h * sin_a))
        oh = int(round(h * cos_a + w * sin_a))
        # keep the original center mapped to the new center
        inv = _inverse_affine_matrix(
            ((ow - 1) * 0.5, (oh - 1) * 0.5), -angle, (0, 0), 1.0, (0, 0))
        shift = np.array([[1, 0, center[0] - (ow - 1) * 0.5],
                          [0, 1, center[1] - (oh - 1) * 0.5],
                          [0, 0, 1]], np.float32)
        inv = shift @ inv
        return _warp(img, inv, (oh, ow), interpolation, fill)
    inv = _inverse_affine_matrix(center, -angle, (0, 0), 1.0, (0, 0))
    return _warp(img, inv, (h, w), interpolation, fill)


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    arr = _to_numpy(img)
    h, w = _hw(arr)
    if isinstance(shear, numbers.Number):
        shear = (shear, 0.0)
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    inv = _inverse_affine_matrix(center, -angle, tuple(translate), scale,
                                 tuple(shear))
    return _warp(img, inv, (h, w), interpolation, fill)


def _homography(src, dst):
    """Solve the 3x3 homography mapping src points -> dst points."""
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    A = np.asarray(A, np.float64)
    _, _, vt = np.linalg.svd(A)
    Hm = vt[-1].reshape(3, 3)
    return (Hm / Hm[2, 2]).astype(np.float32)


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """Warp so `startpoints` (in the input) land on `endpoints`
    (reference: functional.perspective). Sampling uses the inverse map
    (output pixel -> input pixel)."""
    arr = _to_numpy(img)
    h, w = _hw(arr)
    inv = _homography([tuple(p) for p in endpoints],
                      [tuple(p) for p in startpoints])
    return _warp(img, inv, (h, w), interpolation, fill)
