"""Vision transforms, PyTorch port: numpy on the host, HWC or CHW.

Counterpart of `paddle_tpu/vision/transforms/__init__.py`, whose code this
module copies. Transforms run on the host, in the data loader's worker
processes, so they touch no device:

- `ToTensor` / `to_tensor` return a float32 torch tensor on the CPU (the
  reference's returns its framework tensor on the default device); the
  loader moves the batch.
- The random transforms draw from numpy's global generator in the
  reference's order, so under one ``np.random.seed`` both packages draw
  the same values.
- `resize` (the reference's `jax.image.resize`) is
  `torch.nn.functional.interpolate` on a CPU tensor: ``"bilinear"`` and
  ``"bicubic"`` with ``antialias=True, align_corners=False`` (JAX's
  resize filters with the kernel scaled to the output when it
  downsamples), ``"nearest"`` as torch's ``"nearest-exact"`` (torch's
  ``"nearest"`` floors the source coordinate instead of rounding the pixel
  centre); another method raises ValueError. It computes in float64 and
  returns float32, as the reference's resize does under the JAX
  package's x64 mode (in float32 a uint8 result truncates to another
  level on ~1% of pixels). A uint8 image comes back clipped to [0, 255]
  and truncated, as the reference's does.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch
import torch.nn.functional as TF

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Transpose", "Pad", "RandomResizedCrop", "BrightnessTransform",
           "to_tensor", "normalize", "resize", "hflip", "vflip"]


def _to_numpy(img):
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


# resize's methods: the reference's names to F.interpolate's modes and
# arguments
_RESIZE_MODES = {
    "bilinear": dict(mode="bilinear", antialias=True, align_corners=False),
    "linear": dict(mode="bilinear", antialias=True, align_corners=False),
    "bicubic": dict(mode="bicubic", antialias=True, align_corners=False),
    "cubic": dict(mode="bicubic", antialias=True, align_corners=False),
    "nearest": dict(mode="nearest-exact"),
}


def to_tensor(pic, data_format="CHW"):
    arr = _to_numpy(pic)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[None] if data_format == "CHW" else arr[..., None]
    elif arr.ndim == 3 and data_format == "CHW" and arr.shape[-1] in (1, 3, 4):
        arr = arr.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32))


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = _to_numpy(img).astype(np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        arr = (arr - mean[:, None, None]) / std[:, None, None]
    else:
        arr = (arr - mean) / std
    if isinstance(img, torch.Tensor):
        return torch.from_numpy(arr)
    return arr


def resize(img, size, interpolation="bilinear"):
    arr = _to_numpy(img)
    channel_last = arr.ndim == 3 and arr.shape[-1] in (1, 3, 4)
    h, w = (arr.shape[:2] if channel_last or arr.ndim == 2
            else arr.shape[1:3])
    if isinstance(size, numbers.Number):
        if h < w:
            oh, ow = size, int(size * w / h)
        else:
            oh, ow = int(size * h / w), size
    else:
        oh, ow = size
    if interpolation not in _RESIZE_MODES:
        raise ValueError(f"resize interpolation must be one of "
                         f"{sorted(_RESIZE_MODES)}, got {interpolation!r}")
    a = torch.from_numpy(np.array(arr, np.float64))
    if arr.ndim == 2:
        a = a[None, None]
    elif channel_last:
        a = a.permute(2, 0, 1)[None]
    else:
        a = a[None]
    out = TF.interpolate(a, size=(oh, ow),
                         **_RESIZE_MODES[interpolation])[0]
    if arr.ndim == 2:
        out = out[0]
    elif channel_last:
        out = out.permute(1, 2, 0)
    out_np = np.ascontiguousarray(out.numpy(), np.float32)
    if arr.dtype == np.uint8:
        out_np = np.clip(out_np, 0, 255).astype(np.uint8)
    return out_np


def hflip(img):
    arr = _to_numpy(img)
    return arr[..., ::-1].copy() if arr.ndim >= 2 else arr


def vflip(img):
    arr = _to_numpy(img)
    if arr.ndim == 3 and arr.shape[-1] in (1, 3, 4):
        return arr[::-1].copy()
    return arr[..., ::-1, :].copy() if arr.ndim == 3 else arr[::-1].copy()


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def _apply_image(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = (size, size) if isinstance(size, numbers.Number) else size

    def _apply_image(self, img):
        arr = _to_numpy(img)
        channel_last = arr.ndim == 3 and arr.shape[-1] in (1, 3, 4)
        h, w = (arr.shape[:2] if channel_last or arr.ndim == 2
                else arr.shape[1:3])
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        if channel_last or arr.ndim == 2:
            return arr[i:i + th, j:j + tw]
        return arr[:, i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        self.size = (size, size) if isinstance(size, numbers.Number) else size
        self.padding = padding

    def _apply_image(self, img):
        arr = _to_numpy(img)
        channel_last = arr.ndim == 3 and arr.shape[-1] in (1, 3, 4)
        h, w = (arr.shape[:2] if channel_last or arr.ndim == 2
                else arr.shape[1:3])
        th, tw = self.size
        i = np.random.randint(0, max(h - th, 0) + 1)
        j = np.random.randint(0, max(w - tw, 0) + 1)
        if channel_last or arr.ndim == 2:
            return arr[i:i + th, j:j + tw]
        return arr[:, i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return hflip(img)
        return _to_numpy(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return vflip(img)
        return _to_numpy(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def _apply_image(self, img):
        return _to_numpy(img).transpose(self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        if isinstance(padding, numbers.Number):
            padding = [padding] * 4
        self.padding = padding
        self.fill = fill

    def _apply_image(self, img):
        arr = _to_numpy(img)
        l, t, r, b = (self.padding if len(self.padding) == 4
                      else self.padding * 2)
        channel_last = arr.ndim == 3 and arr.shape[-1] in (1, 3, 4)
        if channel_last:
            return np.pad(arr, ((t, b), (l, r), (0, 0)),
                          constant_values=self.fill)
        if arr.ndim == 2:
            return np.pad(arr, ((t, b), (l, r)), constant_values=self.fill)
        return np.pad(arr, ((0, 0), (t, b), (l, r)),
                      constant_values=self.fill)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        self.size = (size, size) if isinstance(size, numbers.Number) else size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = _to_numpy(img)
        channel_last = arr.ndim == 3 and arr.shape[-1] in (1, 3, 4)
        h, w = (arr.shape[:2] if channel_last or arr.ndim == 2
                else arr.shape[1:3])
        area = h * w
        for _ in range(10):
            target_area = area * np.random.uniform(*self.scale)
            aspect = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                              np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                i = np.random.randint(0, h - ch + 1)
                j = np.random.randint(0, w - cw + 1)
                if channel_last or arr.ndim == 2:
                    crop = arr[i:i + ch, j:j + cw]
                else:
                    crop = arr[:, i:i + ch, j:j + cw]
                return resize(crop, self.size, self.interpolation)
        return resize(arr, self.size, self.interpolation)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        arr = _to_numpy(img).astype(np.float32)
        factor = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        out = arr * factor
        return np.clip(out, 0, 255 if arr.max() > 1 else 1.0)


from .functional import (  # noqa: F401,E402
    adjust_brightness, adjust_contrast, adjust_hue, adjust_saturation,
    to_grayscale, crop, center_crop, pad, erase, rotate, affine, perspective,
)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        if value < 0:
            raise ValueError("contrast value should be non-negative")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return _to_numpy(img)
        factor = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, factor)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        if value < 0:
            raise ValueError("saturation value should be non-negative")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return _to_numpy(img)
        factor = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, factor)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        if not 0 <= value <= 0.5:
            raise ValueError("hue value should be in [0, 0.5]")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return _to_numpy(img)
        factor = np.random.uniform(-self.value, self.value)
        return adjust_hue(img, factor)


class ColorJitter(BaseTransform):
    """Randomly jitter brightness/contrast/saturation/hue in random order
    (reference: python/paddle/vision/transforms/transforms.py
    ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        self.transforms = [BrightnessTransform(brightness),
                           ContrastTransform(contrast),
                           SaturationTransform(saturation),
                           HueTransform(hue)]

    def _apply_image(self, img):
        order = np.random.permutation(len(self.transforms))
        for i in order:
            img = self.transforms[i](img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, self.interpolation, self.expand,
                      self.center, self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        arr = _to_numpy(img)
        channel_last = arr.ndim == 2 or (arr.ndim == 3
                                         and arr.shape[-1] in (1, 3, 4))
        h, w = (arr.shape[:2] if channel_last else arr.shape[1:3])
        angle = np.random.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate is not None:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * w
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * h
        sc = np.random.uniform(*self.scale) if self.scale else 1.0
        sh = (0.0, 0.0)
        if self.shear is not None:
            shear = self.shear
            if isinstance(shear, numbers.Number):
                shear = (-abs(shear), abs(shear))
            if len(shear) == 2:
                sh = (np.random.uniform(shear[0], shear[1]), 0.0)
            else:
                sh = (np.random.uniform(shear[0], shear[1]),
                      np.random.uniform(shear[2], shear[3]))
        return affine(img, angle, (tx, ty), sc, sh, self.interpolation,
                      self.fill, self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return _to_numpy(img)
        arr = _to_numpy(img)
        channel_last = arr.ndim == 2 or (arr.ndim == 3
                                         and arr.shape[-1] in (1, 3, 4))
        h, w = (arr.shape[:2] if channel_last else arr.shape[1:3])
        d = self.distortion_scale
        hd = int(h * d / 2)
        wd = int(w * d / 2)
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(np.random.randint(0, wd + 1), np.random.randint(0, hd + 1)),
               (w - 1 - np.random.randint(0, wd + 1),
                np.random.randint(0, hd + 1)),
               (w - 1 - np.random.randint(0, wd + 1),
                h - 1 - np.random.randint(0, hd + 1)),
               (np.random.randint(0, wd + 1),
                h - 1 - np.random.randint(0, hd + 1))]
        return perspective(img, start, end, self.interpolation, self.fill)


class RandomErasing(BaseTransform):
    """Randomly erase a rectangle (reference: transforms.RandomErasing)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img if isinstance(img, torch.Tensor) else _to_numpy(img)
        arr = _to_numpy(img)
        channel_last = arr.ndim == 2 or (arr.ndim == 3
                                         and arr.shape[-1] in (1, 3, 4))
        h, w = (arr.shape[:2] if channel_last else arr.shape[1:3])
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            aspect = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                              np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target / aspect)))
            ew = int(round(np.sqrt(target * aspect)))
            if eh < h and ew < w:
                i = np.random.randint(0, h - eh + 1)
                j = np.random.randint(0, w - ew + 1)
                if self.value == "random":
                    shape = ((eh, ew) + arr.shape[2:] if channel_last
                             else (arr.shape[0], eh, ew))
                    # normal noise like the reference; numpy/PIL images are
                    # in [0, 255] range, so scale (reference scales the
                    # non-tensor branch by 255 regardless of dtype)
                    v = np.random.normal(size=shape)
                    if not isinstance(img, torch.Tensor):
                        v = v * 255.0
                        if np.issubdtype(arr.dtype, np.integer):
                            v = np.clip(v, 0, 255)
                else:
                    v = self.value
                return erase(img, i, j, eh, ew, v, self.inplace)
        return img if isinstance(img, torch.Tensor) else arr


__all__ += ["adjust_brightness", "adjust_contrast", "adjust_hue",
            "adjust_saturation", "to_grayscale", "crop", "center_crop",
            "pad", "erase", "rotate", "affine", "perspective",
            "BaseTransform", "ColorJitter", "ContrastTransform",
            "SaturationTransform", "HueTransform", "Grayscale",
            "RandomRotation", "RandomAffine", "RandomPerspective",
            "RandomErasing"]
