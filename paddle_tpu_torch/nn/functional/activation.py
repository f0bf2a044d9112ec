"""The activations the transformer layers name, under the reference's names
and signatures.

Counterpart of part of `paddle_tpu/nn/functional/activation.py`: the
layers of `nn.layer.transformer` and `incubate.nn` take their activation by
name (``getattr(F, activation)``), so the names they use resolve here:
`relu` and `gelu`, exact unless ``approximate=True`` (tanh), as the
reference's.
"""
from __future__ import annotations

import torch

__all__ = ["relu", "gelu"]


def relu(x):
    return torch.relu(x)


def gelu(x, approximate=False):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")
