"""Carry weights from the JAX package's models into the port.

Counterpart of `paddle_tpu/nn/layer_base.py`'s state-dict / pytree views:
the JAX model's ``named_parameters()`` as numpy arrays (for example
``{n: np.asarray(p._value) for n, p in jax_model.named_parameters()}``)
load into the port's module of the same structure. Names match one to one;
only `nn.Linear` weights change layout (paddle stores ``[in, out]``, torch
``[out, in]``); every other parameter keeps its layout. The modules carried
so far: `GPTForCausalLM`; `nn.MultiHeadAttention`, the
`nn.TransformerEncoder(Layer)` / `TransformerDecoder(Layer)` stacks and
`nn.Transformer` (their projections are `nn.Linear`s); the
`incubate.nn` fused family, `FusedBiasDropoutResidualLayerNorm`,
`FusedMultiHeadAttention`, `FusedFeedForward`,
`FusedTransformerEncoderLayer`, `FusedMultiTransformer` and `FusedLinear`
(raw parameters in Paddle's layout: ``qkv_weight [3, H, D, E]``,
``linear_weight [in, out]``, copied as they are); and
`vision.models.VisionTransformer` on either path (the patch projection is
an `nn.Conv2d`, whose ``[out, in, kh, kw]`` is Paddle's layout too).
`load_jax_optimizer_state` carries a JAX optimizer's accumulators and step
count the same way, so a parity run can continue from one state on both
sides.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_state", "jax_state_values", "load_jax_optimizer_state"]


def _linear_weights(model):
    return {f"{name}.weight" if name else "weight"
            for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def jax_state_values(model: nn.Module, arrays):
    """`arrays` (``{name: np.ndarray}``, the JAX model's named parameters)
    as a list in `model`'s ``parameters()`` order and layout (Linear
    weights transposed to ``[out, in]``), the form `LLMEngine.stage_weights`
    takes. Raises KeyError on a missing or extra name and ValueError on a
    shape mismatch."""
    linear_weights = _linear_weights(model)
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


def load_jax_optimizer_state(topt, tmodel: nn.Module, jopt, jmodel):
    """Copy the JAX optimizer `jopt`'s accumulators (over `jmodel`'s
    parameters) and step count into the port's optimizer `topt` (over
    `tmodel`'s), in place. The JAX side keys its accumulators by parameter
    name (``param_<n>``), so parameters pair by position in the two
    models' ``parameters()`` orders; accumulators of Linear weights are
    transposed as the weights are. Raises ValueError where the models'
    parameter counts or an accumulator's shape disagree, and KeyError
    where `topt` has an accumulator the JAX side lacks."""
    tparams = list(tmodel.named_parameters())
    jparams = list(jmodel.parameters())
    if len(tparams) != len(jparams):
        raise ValueError(f"{len(tparams)} parameters in the port's model, "
                         f"{len(jparams)} in the JAX model")
    linear_weights = _linear_weights(tmodel)
    topt._create_accumulators([p for _, p in tparams])
    with torch.no_grad():
        for acc, per_param in topt._accumulators.items():
            for (name, tp), jp in zip(tparams, jparams):
                if tp not in per_param:
                    continue
                arr = np.asarray(jopt._accumulators[acc][jp.name])
                if name in linear_weights:
                    arr = arr.T
                if tuple(arr.shape) != tuple(per_param[tp].shape):
                    raise ValueError(f"{name} {acc}: expected shape "
                                     f"{tuple(per_param[tp].shape)}, got "
                                     f"{tuple(arr.shape)}")
                # through fp32, which holds a bf16 value exactly
                per_param[tp].copy_(torch.from_numpy(
                    np.ascontiguousarray(arr, dtype=np.float32)))
    topt._step_count = int(getattr(jopt, "_step_count", 0))
    return topt
