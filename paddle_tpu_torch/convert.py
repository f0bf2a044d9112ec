"""Carry weights from the JAX package's models into the port.

Counterpart of `paddle_tpu/nn/layer_base.py`'s state-dict / pytree views:
the JAX model's ``named_parameters()`` as numpy arrays (for example
``{n: np.asarray(p._value) for n, p in jax_model.named_parameters()}``)
load into the port's module of the same structure. Names match one to one;
only `nn.Linear` weights change layout (paddle stores ``[in, out]``, torch
``[out, in]``). The modules carried so far: `GPTForCausalLM` and
`incubate.nn.FusedBiasDropoutResidualLayerNorm` (``linear_bias``,
``ln_scale``, ``ln_bias``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_state", "jax_state_values"]


def jax_state_values(model: nn.Module, arrays):
    """`arrays` (``{name: np.ndarray}``, the JAX model's named parameters)
    as a list in `model`'s ``parameters()`` order and layout (Linear
    weights transposed to ``[out, in]``), the form `LLMEngine.stage_weights`
    takes. Raises KeyError on a missing or extra name and ValueError on a
    shape mismatch."""
    linear_weights = {f"{name}.weight" if name else "weight"
                      for name, mod in model.named_modules()
                      if isinstance(mod, nn.Linear)}
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, extra {extra}")
    staged = {}
    for name, p in params.items():
        arr = np.asarray(arrays[name])
        if name in linear_weights:
            arr = arr.T
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: expected shape {tuple(p.shape)}, got "
                             f"{tuple(arr.shape)}"
                             + (" after transposing [in, out] -> [out, in]"
                                if name in linear_weights else ""))
        staged[name] = arr
    return [staged[name] for name in params]


def load_jax_state(model: nn.Module, arrays):
    """Copy `arrays` (``{name: np.ndarray}``) into `model`'s parameters, in
    place, casting to each parameter's dtype and device. Raises KeyError on
    a missing or extra name and ValueError on a shape mismatch; nothing is
    copied unless every name and shape checks out."""
    values = jax_state_values(model, arrays)
    with torch.no_grad():
        for p, arr in zip(model.parameters(), values):
            p.copy_(torch.tensor(arr))
    return model
