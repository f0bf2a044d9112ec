"""Fused transformer building blocks, PyTorch port.

Counterpart of `paddle_tpu/incubate/nn/fused_transformer.py`:
`FusedBiasDropoutResidualLayerNorm` (the fused bias-residual LayerNorm
kernel), `FusedMultiHeadAttention`, `FusedFeedForward`,
`FusedTransformerEncoderLayer`, `FusedMultiTransformer` and `FusedLinear`.

Their parameters are raw `nn.Parameter`s with the reference's names,
shapes and layouts, not `nn.Linear`s: ``qkv_weight [3, H, D, E]``,
``linear_weight [E, E]`` read as ``x @ W``, ``linear1_weight [d_model,
dim_ff]``; so `convert.load_jax_state` copies them without a transpose.
Each layer runs the functional of the same name in `.functional` (the
attention core on the flash kernels where eligible). Post-LN is a plain
LayerNorm, as in the reference. Weights draw from the reference's
initializers (XavierUniform for the attention and feed-forward weights,
XavierNormal for `FusedLinear`, zeros for biases, ones for LayerNorm
scales) through `generator`, or torch's default generator; a ``*_attr``
argument may name another `nn.initializer` initializer, and a bias attr
of False leaves the bias out. ``device=None`` means ``cuda`` and raises
where there is no card; pass ``device="cpu"`` for the plain versions.
"""
from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from ...nn import initializer as I
from .functional import (fused_bias_dropout_residual_layer_norm,
                         fused_feedforward, fused_linear,
                         fused_multi_head_attention)

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedBiasDropoutResidualLayerNorm", "FusedLinear"]


def _parameter(shape, attr, default, device, generator):
    """A parameter of `shape` filled by `attr`'s initializer (`default`
    for None); None for ``attr=False``."""
    if attr is False:
        return None
    p = nn.Parameter(torch.empty(shape, device=device))
    I.from_attr(attr, default)(p, generator)
    return p


def _weight(shape, attr, device, generator, default=None):
    return _parameter(shape, attr, default or I.XavierUniform(), device,
                      generator)


def _bias(shape, attr, device, generator):
    return _parameter(shape, attr, I.Constant(0.0), device, generator)


def _scale(shape, attr, device, generator):
    return _parameter(shape, attr, I.Constant(1.0), device, generator)


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


class FusedMultiHeadAttention(nn.Module):
    """LayerNorm before (``normalize_before``) or after, the qkv
    projection, attention, the out projection, dropout and the residual
    (`functional.fused_multi_head_attention`). As the reference's layer,
    it attends `query` to itself: `key`, `value` and `cache` are taken and
    not read."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon
        g = (device, generator)
        self.qkv_weight = _weight([3, num_heads, self.head_dim, embed_dim],
                                  qkv_weight_attr, *g)
        self.qkv_bias = _bias([3, num_heads, self.head_dim], qkv_bias_attr,
                              *g)
        self.linear_weight = _weight([embed_dim, embed_dim],
                                     linear_weight_attr, *g)
        self.linear_bias = _bias([embed_dim], linear_bias_attr, *g)
        self.pre_ln_scale = _scale([embed_dim], pre_ln_scale_attr, *g)
        self.pre_ln_bias = _bias([embed_dim], pre_ln_bias_attr, *g)
        self.ln_scale = _scale([embed_dim], ln_scale_attr, *g)
        self.ln_bias = _bias([embed_dim], ln_bias_attr, *g)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self._epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, attn_mask=attn_mask,
            dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            ln_epsilon=self._epsilon, training=self.training)

    def extra_repr(self):
        return (f"embed_dim={self.embed_dim}, num_heads={self.num_heads}, "
                f"normalize_before={self.normalize_before}")


class FusedFeedForward(nn.Module):
    """LayerNorm before or after, ``act(x @ W1 + b1) @ W2 + b2`` with
    dropouts, and the residual (`functional.fused_feedforward`)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-05, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self._d_model = d_model
        self._epsilon = epsilon
        self._dropout_rate = dropout_rate
        self._act_dropout_rate = dropout_rate if act_dropout_rate is None \
            else act_dropout_rate
        self._act = activation
        self.normalize_before = normalize_before
        g = (device, generator)
        self.linear1_weight = _weight([d_model, dim_feedforward],
                                      linear1_weight_attr, *g)
        self.linear1_bias = _bias([dim_feedforward], linear1_bias_attr, *g)
        self.linear2_weight = _weight([dim_feedforward, d_model],
                                      linear2_weight_attr, *g)
        self.linear2_bias = _bias([d_model], linear2_bias_attr, *g)
        self.ln1_scale = _scale([d_model], ln1_scale_attr, *g)
        self.ln1_bias = _bias([d_model], ln1_bias_attr, *g)
        self.ln2_scale = _scale([d_model], ln2_scale_attr, *g)
        self.ln2_bias = _bias([d_model], ln2_bias_attr, *g)

    def forward(self, src, cache=None):
        return fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            linear1_bias=self.linear1_bias, linear2_bias=self.linear2_bias,
            ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=self._act_dropout_rate,
            dropout2_rate=self._dropout_rate, activation=self._act,
            ln1_epsilon=self._epsilon, ln2_epsilon=self._epsilon,
            pre_layer_norm=self.normalize_before, training=self.training)


class FusedTransformerEncoderLayer(nn.Module):
    """`FusedMultiHeadAttention` then `FusedFeedForward` (``fused_attn``,
    ``ffn``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, device=None,
                 generator=None):
        super().__init__()
        attn_dropout_rate = dropout_rate if attn_dropout_rate is None \
            else attn_dropout_rate
        act_dropout_rate = dropout_rate if act_dropout_rate is None \
            else act_dropout_rate
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before, device=device,
            generator=generator)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, device=device,
            generator=generator)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(nn.Module):
    """`num_layers` `FusedTransformerEncoderLayer`s (``layers``), pre-LN
    and gelu by default, the reference's stacked block. `caches` and the
    reference's other serving arguments are taken and not read."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, epsilon=1e-5, device=None, generator=None,
                 **unused):
        super().__init__()
        self.layers = nn.ModuleList([
            FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward, dropout_rate,
                activation, normalize_before=normalize_before,
                device=device, generator=generator)
            for _ in range(num_layers)])

    def forward(self, src, attn_mask=None, caches=None, **kwargs):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=attn_mask)
        return out


class FusedLinear(nn.Module):
    """``x @ weight + bias`` (`functional.fused_linear`): weight ``[in,
    out]``, or stored ``[out, in]`` and read transposed where
    `transpose_weight`, as the reference's; XavierNormal, the bias zeros
    (none for ``bias_attr=False``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self._transpose_weight = transpose_weight
        shape = [out_features, in_features] if transpose_weight \
            else [in_features, out_features]
        self.weight = _weight(shape, weight_attr, device, generator,
                              default=I.XavierNormal())
        self.bias = _bias([out_features], bias_attr, device, generator)

    def forward(self, input):
        return fused_linear(input, self.weight, self.bias,
                            transpose_weight=self._transpose_weight)
