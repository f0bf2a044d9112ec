"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package mirrors its
module paths and class names (``incubate.models.gpt``, ``serving.engine``,
``nn.functional.attention``, ``kernels.*``) so each counterpart is easy to
find, and writes PyTorch's own idiom inside: `nn.Module`s, plain functions
on tensors, an explicit ``device`` and explicit `torch.Generator`s.

Every Pallas kernel on a ported path is a hand-written CUDA C++ kernel for
Hopper (``csrc/*.cu``), built with nvcc at first use and bound through
ctypes (`kernels._build`). On a CUDA tensor a kernel wrapper launches its
kernel or raises; only a tensor on the CPU takes the kernel's plain PyTorch
twin. Entry points default to ``device="cuda"``.

This package imports neither `jax` nor `paddle_tpu`.
"""
from __future__ import annotations

from .device import default_device, resolve_device, require_hopper  # noqa: F401

__all__ = ["default_device", "resolve_device", "require_hopper"]

__version__ = "0.1.0"       # the JAX package's version, which it ports
