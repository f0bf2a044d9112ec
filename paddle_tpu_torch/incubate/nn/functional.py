"""Fused functionals of the incubate namespace.

Counterpart of `paddle_tpu/incubate/nn/functional.py`:
`fused_bias_dropout_residual_layer_norm` (the fused bias-residual
LayerNorm kernel when eligible, the composite path otherwise),
`fused_softmax_cross_entropy` (the fused cross-entropy kernels), and the
transformer family's functionals `fused_linear`, `fused_matmul_bias`,
`fused_multi_head_attention`, `fused_feedforward` and
`fused_multi_transformer`.

The transformer functionals take raw weights in Paddle's layout: a linear
weight is ``[in, out]`` and the product is ``x @ W`` (torch's
`nn.functional.linear` takes ``[out, in]`` and is not used here); the qkv
weight is ``[3, H, D, E]`` (``[E, 3, H, D]`` where ``trans_qkvw=False``).
A product with a bias is one `torch.addmm` over the flattened rows, so
cuBLAS adds the bias in its epilogue, as the reference's
fused_gemm_epilogue does. Their attention core is
`nn.functional.scaled_dot_product_attention`: the flash kernels for an
unmasked call at head_dim 64 or 128. The reference's `cache_kv`,
`cache_kvs` and `time_step` (its serving caches) raise NotImplementedError
with the reference's messages.
"""
from __future__ import annotations

import torch

from ...kernels import cross_entropy as _fused_ce
from ...kernels import fused_ln as _fused_ln
from ...nn import functional as F
from ...nn.functional.loss import cross_entropy

__all__ = ["fused_bias_dropout_residual_layer_norm",
           "fused_softmax_cross_entropy", "fused_linear", "fused_matmul_bias",
           "fused_multi_head_attention", "fused_feedforward",
           "fused_multi_transformer"]


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


def _matmul_bias(x, w, bias=None):
    """``x @ w (+ bias)`` over x's last axis, w ``[in, out]``: with a bias
    one `torch.addmm` over x's rows (the bias in cuBLAS's epilogue)."""
    if bias is None:
        return torch.matmul(x, w)
    out = torch.addmm(bias, x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _layer_norm_last(x, weight, bias, eps):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), weight, bias,
                                          eps)


def fused_linear(x, weight, bias=None, transpose_weight=False):
    """``x @ weight + bias``; weight ``[in, out]``, or ``[out, in]`` read
    transposed where `transpose_weight`."""
    return _matmul_bias(x, weight.t() if transpose_weight else weight, bias)


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False):
    """``matmul(x, y) + bias``, each operand's last two axes swapped where
    its ``transpose_*`` says."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    if bias is not None and x.ndim >= 2 and y.ndim == 2:
        return _matmul_bias(x, y, bias)
    out = torch.matmul(x, y)
    return out if bias is None else out + bias


def fused_multi_head_attention(
        x, qkv_weight, linear_weight, pre_layer_norm=False,
        pre_ln_scale=None, pre_ln_bias=None, ln_scale=None, ln_bias=None,
        pre_ln_epsilon=1e-05, qkv_bias=None, linear_bias=None,
        cache_kv=None, attn_mask=None, dropout_rate=0.5,
        attn_dropout_rate=0.5, ln_epsilon=1e-05, training=True,
        mode="upscale_in_train", add_residual=True):
    """The reference's fused attention block on ``x [B, N, E]``: LayerNorm
    first where `pre_layer_norm`, the qkv projection (qkv_weight ``[3, H,
    D, E]``, qkv_bias ``[3, H, D]``), attention over q, k, v as strided
    views of one ``[B, N, 3, H, D]`` product, the out projection
    (linear_weight ``[H·D, E]``), dropout in training, the residual where
    `add_residual`, and LayerNorm after where not `pre_layer_norm`."""
    if cache_kv is not None:
        raise NotImplementedError(
            "fused_multi_head_attention cache_kv: use the compiled decode "
            "path (incubate.models.GPTDecodeStep / model.generate()) — the "
            "static-KV serving cache lives there on TPU")
    n_heads, head_dim, embed = qkv_weight.shape[1:]
    residual = x
    if pre_layer_norm:
        x = _layer_norm_last(x, pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    # [E, 3·H·D] as a view of [3, H, D, E]: no copy of the weight
    wmat = qkv_weight.reshape(3 * n_heads * head_dim, embed).t()
    qkv = _matmul_bias(x, wmat, None if qkv_bias is None
                       else qkv_bias.reshape(-1))
    b, n = x.shape[0], x.shape[1]
    q, k, v = qkv.reshape(b, n, 3, n_heads, head_dim).unbind(2)
    ctx = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0, training=training)
    out = _matmul_bias(ctx.reshape(b, n, n_heads * head_dim), linear_weight,
                       linear_bias)
    if dropout_rate and training:
        out = _dropout(out, dropout_rate, True, "upscale_in_train")
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = _layer_norm_last(out, ln_scale, ln_bias, ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", add_residual=True):
    """``residual + dropout(act(x @ W1 + b1) @ W2 + b2)`` with LayerNorm
    before (`pre_layer_norm`, ln1) or after (ln2); W1 ``[d_model,
    dim_ff]``, W2 ``[dim_ff, d_model]``; the activation by name from
    `nn.functional`."""
    residual = x
    if pre_layer_norm:
        x = _layer_norm_last(x, ln1_scale, ln1_bias, ln1_epsilon)
    h = getattr(F, activation)(_matmul_bias(x, linear1_weight, linear1_bias))
    if dropout1_rate and training:
        h = _dropout(h, dropout1_rate, True, "upscale_in_train")
    h = _matmul_bias(h, linear2_weight, linear2_bias)
    if dropout2_rate and training:
        h = _dropout(h, dropout2_rate, True, "upscale_in_train")
    out = residual + h if add_residual else h
    if not pre_layer_norm:
        out = _layer_norm_last(out, ln2_scale, ln2_bias, ln2_epsilon)
    return out


def fused_multi_transformer(
        x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
        linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
        ffn1_biases, ffn2_weights, ffn2_biases, pre_layer_norm=True,
        epsilon=1e-05, cache_kvs=None, pre_caches=None, time_step=None,
        attn_mask=None, dropout_rate=0.0, activation="gelu",
        training=False, mode="upscale_in_train", trans_qkvw=True):
    """L blocks of `fused_multi_head_attention` then `fused_feedforward`,
    one for each entry of the weight lists (a list given as None means no
    such term); ``trans_qkvw=False`` reads each qkv weight as ``[E, 3, H,
    D]``."""
    if cache_kvs is not None or time_step is not None:
        raise NotImplementedError(
            "fused_multi_transformer cache_kvs/time_step: use the compiled "
            "decode path (incubate.models.GPTDecodeStep / generate()) for "
            "serving caches on TPU")
    if not trans_qkvw:
        qkv_weights = [w.permute(1, 2, 3, 0) for w in qkv_weights]

    def nth(values, i):
        return values[i] if values else None

    out = x
    for i in range(len(qkv_weights)):
        out = fused_multi_head_attention(
            out, qkv_weights[i], linear_weights[i],
            pre_layer_norm=pre_layer_norm, pre_ln_scale=nth(ln_scales, i),
            pre_ln_bias=nth(ln_biases, i), pre_ln_epsilon=epsilon,
            qkv_bias=nth(qkv_biases, i), linear_bias=nth(linear_biases, i),
            attn_mask=attn_mask, dropout_rate=dropout_rate,
            attn_dropout_rate=dropout_rate, training=training)
        out = fused_feedforward(
            out, ffn1_weights[i], ffn2_weights[i],
            linear1_bias=nth(ffn1_biases, i),
            linear2_bias=nth(ffn2_biases, i),
            ln1_scale=nth(ffn_ln_scales, i), ln1_bias=nth(ffn_ln_biases, i),
            ln1_epsilon=epsilon, pre_layer_norm=pre_layer_norm,
            dropout1_rate=dropout_rate, dropout2_rate=dropout_rate,
            activation=activation, training=training)
    return out
