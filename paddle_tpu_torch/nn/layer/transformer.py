"""Transformer layers, PyTorch port.

Counterpart of `paddle_tpu/nn/layer/transformer.py`: `MultiHeadAttention`
(with its `Cache` / `StaticCache` decoding caches and `gen_cache`),
`TransformerEncoderLayer` / `TransformerEncoder`,
`TransformerDecoderLayer` / `TransformerDecoder` and `Transformer`.
Sub-modules and parameters keep the reference's names (``q_proj``,
``k_proj``, ``v_proj``, ``out_proj``, ``linear1``, ``linear2``, ``norm1``,
...), so `convert.load_jax_state` carries a JAX layer across; the
projections are `nn.Linear`s in torch's ``[out, in]`` layout (`convert`
transposes their weights). Weights draw from the reference's initializers
(`nn.initializer`: XavierNormal for the Linear weights, zeros for biases,
LayerNorm at (1, 0)) through `generator`, or torch's default generator.

Attention goes through `nn.functional.scaled_dot_product_attention` on
``[B, N, H, D]``, non-causal, as the reference calls it: an unmasked call
with head_dim 64 or 128 takes the flash kernels on the card (their twins
on the CPU), also for cross-attention and a `Cache` step, where queries and
keys differ in number; a masked call and other head dims take the plain
path. A bool mask keeps where True; a float mask is added to the scores.

``device=None`` means ``cuda`` and raises where there is no card; pass
``device="cpu"`` for the plain versions.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def linear(in_features, out_features, weight_attr=None, bias_attr=None,
           device=None, generator=None):
    """The reference's `nn.Linear` as a torch `nn.Linear`: the weight from
    `weight_attr`'s initializer (XavierNormal by default; its sum of fans
    is the same in either layout), the bias zeros, none for ``bias_attr=
    False``."""
    layer = nn.Linear(in_features, out_features, bias=bias_attr is not False,
                      device=device)
    I.from_attr(weight_attr, I.XavierNormal())(layer.weight, generator)
    if layer.bias is not None:
        I.from_attr(bias_attr, I.Constant(0.0))(layer.bias, generator)
    return layer


class MultiHeadAttention(nn.Module):
    """q / k / v / out projections around the scaled-dot-product core, with
    caches for decoding: a `Cache` grows by this call's keys and values
    (self-attention), a `StaticCache` holds projected keys and values that
    every call reads (cross-attention over a fixed memory)."""

    class Cache:
        def __init__(self, k, v):
            self.k = k
            self.v = v

    class StaticCache:
        def __init__(self, k, v):
            self.k = k
            self.v = v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=device,
                  generator=generator)
        self.q_proj = linear(embed_dim, embed_dim, **kw)
        self.k_proj = linear(self.kdim, embed_dim, **kw)
        self.v_proj = linear(self.vdim, embed_dim, **kw)
        self.out_proj = linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """``type=MultiHeadAttention.StaticCache``: `key` and `value` (`key`
        when None) projected once; otherwise an empty `Cache` ``[B, 0, H,
        D]`` in key's dtype and device."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None
                                              else key))
            return MultiHeadAttention.StaticCache(k, v)
        empty = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                            dtype=key.dtype, device=key.device)
        return MultiHeadAttention.Cache(empty, empty)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, MultiHeadAttention.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = MultiHeadAttention.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None and not isinstance(
                cache, MultiHeadAttention.StaticCache):
            return out, cache
        return out


class TransformerEncoderLayer(nn.Module):
    """Self-attention then a feed-forward pair, each with a residual and a
    LayerNorm before (``normalize_before``, pre-LN) or after (post-LN)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=device,
                  generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = linear(d_model, dim_feedforward, **kw)
        self.dropout = nn.Dropout(act_dropout)
        self.linear2 = linear(dim_feedforward, d_model, **kw)
        self.norm1 = nn.LayerNorm(d_model, device=device)
        self.norm2 = nn.LayerNorm(d_model, device=device)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _clones(layer, num_layers):
    """`layer` first, then deep copies of it (the reference's stacking: the
    copies start from the first layer's values)."""
    return nn.ModuleList([layer if i == 0 else copy.deepcopy(layer)
                          for i in range(num_layers)])


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """Self-attention, cross-attention over `memory`, then the feed-forward
    pair, each with a residual and a LayerNorm (pre- or post-LN)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=device,
                  generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **kw)
        self.linear1 = linear(d_model, dim_feedforward, **kw)
        self.dropout = nn.Dropout(act_dropout)
        self.linear2 = linear(dim_feedforward, d_model, **kw)
        self.norm1 = nn.LayerNorm(d_model, device=device)
        self.norm2 = nn.LayerNorm(d_model, device=device)
        self.norm3 = nn.LayerNorm(d_model, device=device)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.dropout3 = nn.Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache, cache[1]))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask, memory_mask,
                                        cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(nn.Module):
    """Encoder over `src`, decoder over `tgt` and the encoder's memory; a
    final LayerNorm on each stack when pre-LN."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_norm = nn.LayerNorm(d_model, device=device) \
                if normalize_before else None
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, device=device,
                                        generator=generator),
                num_encoder_layers, enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_norm = nn.LayerNorm(d_model, device=device) \
                if normalize_before else None
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, device=device,
                                        generator=generator),
                num_decoder_layers, dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """``[length, length]`` fp32 on the model's device: 0 on and below
        the diagonal, -1e9 above it (the reference's additive causal
        mask)."""
        keep = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                     device=next(self.parameters()).device))
        return torch.where(keep, 0.0, -1e9).float()
