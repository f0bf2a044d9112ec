"""Fused functionals of the incubate namespace.

Counterpart of `paddle_tpu/incubate/nn/functional.py`:
`fused_bias_dropout_residual_layer_norm` (the fused bias-residual
LayerNorm kernel when eligible, the composite path otherwise) and
`fused_softmax_cross_entropy` (the fused cross-entropy kernels).
`fused_linear` is not ported (ROADMAP.md Queue 1 item 8).
"""
from __future__ import annotations

import torch

from ...kernels import cross_entropy as _fused_ce
from ...kernels import fused_ln as _fused_ln
from ...nn.functional.loss import cross_entropy

__all__ = ["fused_bias_dropout_residual_layer_norm",
           "fused_softmax_cross_entropy"]


def _dropout(x, p, training, mode):
    """Paddle's dropout (`paddle_tpu/nn/functional/common.py`): in
    training keep with probability 1 - p and, under ``upscale_in_train``,
    divide by 1 - p; at inference ``downscale_in_infer`` multiplies by
    1 - p. The mask comes from torch's generator (not JAX's bits)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    keep = torch.empty_like(x).bernoulli_(1.0 - p)
    if mode == "upscale_in_train":
        return x * keep / (1.0 - p)
    return x * keep


def _layer_norm(x, weight, bias, eps):
    """The reference's `nn.functional.layer_norm` over the last axis: fp32
    statistics, the normalised value cast back to x's dtype, then the
    affine terms in their own dtype (type promotion as in jnp)."""
    z = x.float()
    mean = z.mean(dim=-1, keepdim=True)
    var = z.var(dim=-1, unbiased=False, keepdim=True)
    out = ((z - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train"):
    """y = LayerNorm(residual + dropout(x + bias)) * ln_scale + ln_bias.

    Dropout in training, or under ``downscale_in_infer`` at inference,
    takes the composite path, as does a call the kernel does not take
    (`kernels.fused_ln.is_eligible`: the flag, ``d % 128 == 0``). Otherwise
    x and residual flatten to ``[-1, d]`` and go through the fused kernel's
    autograd Function (its plain twin on the CPU); absent bias, scale or
    shift are fp32 zeros, ones or zeros."""
    d = x.shape[-1]
    needs_dropout = dropout_rate > 0.0 and (
        training or mode == "downscale_in_infer")
    if needs_dropout or not _fused_ln.is_eligible(x, d):
        h = x if bias is None else x + bias
        if needs_dropout:
            h = _dropout(h, dropout_rate, training, mode)
        return _layer_norm(h + residual, ln_scale, ln_bias, ln_epsilon)

    def vec(t, fill):
        if t is not None:
            return t
        return torch.full((d,), fill, dtype=torch.float32, device=x.device)

    out = _fused_ln.fused_bias_residual_layer_norm(
        x.reshape(-1, d).contiguous(), residual.reshape(-1, d).contiguous(),
        vec(bias, 0.0), vec(ln_scale, 1.0), vec(ln_bias, 0.0), ln_epsilon)
    return out.reshape(x.shape)


def fused_softmax_cross_entropy(logits, label, ignore_index=-100,
                                reduction="mean"):
    """Cross-entropy through the fused kernels whatever
    ``FLAGS_use_fused_cross_entropy`` and the vocabulary size say (the
    explicit entry point); only logits that are not 2-D with 1-D labels take
    `nn.functional.cross_entropy` instead, as in the reference."""
    if _fused_ce.is_eligible(logits, label, force=True):
        lab_idx = torch.clamp(label, 0, logits.shape[1] - 1).long()
        nll = _fused_ce.fused_softmax_cross_entropy(logits, lab_idx)
        return _fused_ce.masked_reduce(nll, label, ignore_index, reduction)
    return cross_entropy(logits, label, ignore_index=ignore_index,
                         reduction=reduction)
