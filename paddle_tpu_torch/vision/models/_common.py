"""What the conv nets of `vision.models` share: the device and generator
every layer of a model is built with."""
from __future__ import annotations

import torch

from ...device import resolve_device


def device_and_generator(device, seed):
    """``dict(device=, generator=)`` for a model's layers: `device` resolved
    (None means ``cuda``, raising where there is none) and a
    `torch.Generator` on it seeded with `seed`."""
    device = resolve_device(device)
    return dict(device=device, generator=torch.Generator(
        device=device).manual_seed(int(seed)))


def no_pretrained(pretrained):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a state_dict")
