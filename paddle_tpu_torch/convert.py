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

Buffers travel with the parameters: `arrays` holds the JAX model's
``named_buffers()`` too (a batch norm's ``_mean`` / ``_variance``), under
the same names as the port's persistent buffers, and a name missing from
either side raises as a parameter's does. The conv nets of
`vision.models` are carried so (their convolutions' ``[out, in / groups,
*k]`` weights are Paddle's layout too, and a Momentum velocity on them
needs no transpose).
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


def _persistent_buffers(model):
    """``{name: buffer}`` of `model`'s buffers that its state dict holds."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, b in mod._buffers.items():
            if b is not None and name not in mod._non_persistent_buffers_set:
                out[f"{prefix}.{name}" if prefix else name] = b
    return out


def jax_state_values(model: nn.Module, arrays):
    """`arrays` (``{name: np.ndarray}``, the JAX model's named parameters
    and buffers) as a list in `model`'s ``parameters()`` order and layout
    (Linear weights transposed to ``[out, in]``), then its persistent
    buffers in ``named_buffers()`` order: the form
    `LLMEngine.stage_weights` takes (a GPT has no buffers). Raises
    KeyError on a missing or extra name and ValueError on a shape
    mismatch."""
    linear_weights = _linear_weights(model)
    state = {**dict(model.named_parameters()), **_persistent_buffers(model)}
    missing = sorted(set(state) - set(arrays))
    extra = sorted(set(arrays) - set(state))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, extra {extra}")
    staged = []
    for name, t in state.items():
        arr = np.asarray(arrays[name])
        if name in linear_weights:
            arr = arr.T
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}: expected shape {tuple(t.shape)}, got "
                             f"{tuple(arr.shape)}"
                             + (" after transposing [in, out] -> [out, in]"
                                if name in linear_weights else ""))
        staged.append(arr)
    return staged


def load_jax_state(model: nn.Module, arrays):
    """Copy `arrays` (``{name: np.ndarray}``, parameters and buffers) into
    `model`'s parameters and persistent buffers, in place, casting to each
    one's dtype and device. Raises KeyError on a missing or extra name and
    ValueError on a shape mismatch; nothing is copied unless every name and
    shape checks out."""
    values = jax_state_values(model, arrays)
    targets = list(dict(model.named_parameters()).values()) + list(
        _persistent_buffers(model).values())
    with torch.no_grad():
        for t, arr in zip(targets, values):
            t.copy_(torch.tensor(arr))
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
