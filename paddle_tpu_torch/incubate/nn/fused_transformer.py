"""Fused transformer building blocks, PyTorch port.

Counterpart of `paddle_tpu/incubate/nn/fused_transformer.py`; so far only
`FusedBiasDropoutResidualLayerNorm`, the one class there that reaches a TPU
kernel (the fused bias-residual LayerNorm). `FusedMultiHeadAttention`,
`FusedFeedForward`, `FusedTransformerEncoderLayer`,
`FusedMultiTransformer` and `FusedLinear` are ROADMAP.md Queue 1 item 8.
"""
from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from .functional import fused_bias_dropout_residual_layer_norm

__all__ = ["FusedBiasDropoutResidualLayerNorm"]


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """y = LayerNorm(residual + dropout(x + linear_bias)) * ln_scale +
    ln_bias over the last axis of width `embed_dim`.

    Parameters keep the reference's names (`linear_bias`, `ln_scale`,
    `ln_bias`; zeros, ones and zeros), so `convert.load_jax_state` carries
    a JAX layer's values across. ``device=None`` means ``cuda`` and raises
    where there is no card; pass ``device="cpu"`` for the plain versions.
    In training with ``dropout_rate > 0`` the layer takes the composite
    path; otherwise eligible widths (``embed_dim % 128 == 0``) run the
    fused kernel.
    """

    def __init__(self, embed_dim, dropout_rate=0.5, epsilon=1e-5,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim = int(embed_dim)
        self.dropout_rate = dropout_rate
        self._epsilon = epsilon
        self.linear_bias = nn.Parameter(torch.zeros(self.embed_dim,
                                                    device=device))
        self.ln_scale = nn.Parameter(torch.ones(self.embed_dim, device=device))
        self.ln_bias = nn.Parameter(torch.zeros(self.embed_dim, device=device))

    def forward(self, x, residual):
        return fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self.dropout_rate,
            ln_epsilon=self._epsilon, training=self.training)

    def extra_repr(self):
        return f"embed_dim={self.embed_dim}, dropout_rate={self.dropout_rate}"
