"""Device rules of the PyTorch/CUDA port.

Counterpart of `paddle_tpu/kernels/_common.py::on_tpu`. The port's entry
points run on a CUDA card unless the caller asks for the CPU: with
``device=None`` they resolve to ``cuda`` and raise where no card exists,
so a run meant for the card never carries on quietly on the host. The
hand-written kernels target Hopper (``sm_90a``); `require_hopper` is the
check their wrappers make before a launch.
"""
from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device", "require_hopper"]


def default_device():
    """The device an entry point uses when the caller names none: ``cuda``.
    Raises where no CUDA device is available."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return torch.device("cuda")


def resolve_device(device=None):
    """`device` as a `torch.device`, or `default_device()` when None."""
    if device is None:
        return default_device()
    return torch.device(device)


def require_hopper(t):
    """Raise unless tensor `t` lives on a compute-capability 9.0 (Hopper)
    card: the kernels are compiled for ``sm_90a`` only."""
    if t.device.type != "cuda":
        raise RuntimeError(f"expected a CUDA tensor, got one on {t.device}")
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"paddle_tpu_torch kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(t.device)} has compute "
            f"capability {cap[0]}.{cap[1]}")
