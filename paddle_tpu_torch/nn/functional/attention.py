"""Scaled-dot-product attention and one paged decode step.

Counterpart of `paddle_tpu/nn/functional/attention.py`
(`_plain_attention`, `scaled_dot_product_attention`,
`_dense_gather_attention`, `paged_decode_attention`, `PAGED_KERNELS` and
`resolve_paged_kernel`). Layouts are the JAX package's: q, k, v ``[batch,
seq, heads, head_dim]``.
"""
from __future__ import annotations

import math

import torch

from ... import amp
from ...framework.flags import get_flags
from ...kernels.flash_attention import (DTYPES as _FLASH_DTYPES,
                                        HEAD_DIMS as _FLASH_HEAD_DIMS,
                                        FlashAttention)
from ...kernels.kv_append import kv_append_reference
from ...kernels.paged_attention import paged_decode_append
from ...quantization.kv_cache import dequantize

__all__ = ["scaled_dot_product_attention", "paged_decode_attention",
           "PAGED_KERNELS", "resolve_paged_kernel"]

# the serving attention variants, by the reference's names: "pallas" and
# "blockwise" both run the hand-written paged kernel (the reference's
# blockwise path is the plain twin of its Pallas kernel, the same streaming
# math), "reference" the dense-gather oracle
PAGED_KERNELS = ("pallas", "blockwise", "reference")

_NEG_INF = -1e30
# -1e30 in each float type (-inf in float16), as host floats computed
# once: `torch.export` keeps them constants of a traced program
_NEG_BY_TYPE = {dt: float(torch.tensor(_NEG_INF).to(dt))
                for dt in (torch.float32, torch.bfloat16, torch.float16,
                           torch.float64)}


def _plain_attention(q, k, v, mask, is_causal, scale, dropout_p=0.0):
    """softmax(QK^T * scale) V with the BOTTOM-RIGHT causal alignment: with
    cached keys (m > n), query i sits at absolute position i + (m - n)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    scores = (qt @ kt.transpose(-1, -2)) * scale            # [B, H, N, M]
    n, m = scores.shape[-2], scores.shape[-1]
    # -1e30 in the scores' dtype, as the reference's: -inf in float16
    neg = _NEG_BY_TYPE[scores.dtype]
    if is_causal:
        q_pos = torch.arange(n, device=q.device)[:, None] + (m - n)
        k_pos = torch.arange(m, device=q.device)[None, :]
        scores = scores.masked_fill(q_pos < k_pos, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, neg)
        else:
            scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
    if dropout_p:
        probs = torch.nn.functional.dropout(probs, dropout_p, training=True)
    return (probs @ vt).transpose(1, 2)


def _flash_eligible(q, k, mask, dropout_p, is_causal):
    """The flash route: ``FLAGS_use_flash_attention``, no mask, no dropout,
    [B, N, H, D] with D in the kernel's head dims, n == m when causal (the
    kernel's mask is top-left). No minimum length: the kernels mask their
    own ragged edges. fp32, bf16 and float16 each have their kernel."""
    if mask is not None or dropout_p:
        return False
    if not get_flags("FLAGS_use_flash_attention")["FLAGS_use_flash_attention"]:
        return False
    if q.ndim != 4 or q.shape[-1] not in _FLASH_HEAD_DIMS \
            or (is_causal and q.shape[1] != k.shape[1]):
        return False
    return q.dtype in _FLASH_DTYPES


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """query/key/value: ``[batch, seq, num_heads, head_dim]``. Flash-eligible
    calls go through the autograd `FlashAttention` on both devices (the
    CUDA kernels forward and backward on the card, their plain twins on the
    CPU); the rest take the plain path. Under `amp.auto_cast` the call is
    one op, the reference's ``scaled_dot_product_attention``: its inputs
    are cast by the policy, its body is not."""
    inputs = [query, key, value] + ([attn_mask] if attn_mask is not None
                                    else [])
    query, key, value, *mask = amp.amp_cast_inputs(
        "scaled_dot_product_attention", inputs)
    attn_mask = mask[0] if mask else None
    scale = 1.0 / math.sqrt(query.shape[-1])
    eff_dropout = dropout_p if training else 0.0
    with amp.suspended():
        if _flash_eligible(query, key, attn_mask, eff_dropout, is_causal):
            return FlashAttention.apply(query, key, value, is_causal, scale)
        return _plain_attention(query, key, value, attn_mask, is_causal,
                                scale, eff_dropout)


def _dense_gather_attention(qh, k_pool, v_pool, block_tables, lens,
                            block_size, k_scales=None, v_scales=None):
    """The oracle: gather by block table into a dense ``[S, T, H, D]``
    context (int8 pools dequantized under their scales), full fp32
    softmax; only the output casts back."""
    s, h, d = qh.shape
    t_max = block_tables.shape[1] * block_size
    tables = block_tables.long()
    if k_scales is not None:
        keys = dequantize(k_pool[tables], k_scales[tables])
        vals = dequantize(v_pool[tables], v_scales[tables])
    else:
        keys = k_pool[tables].float()
        vals = v_pool[tables].float()
    keys = keys.reshape(s, t_max, h, d)
    vals = vals.reshape(s, t_max, h, d)
    scores = torch.einsum("shd,sthd->sht", qh.float(), keys) / math.sqrt(d)
    valid = torch.arange(t_max, device=qh.device)[None, :] \
        <= lens.long()[:, None]
    scores = scores.masked_fill(~valid[:, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("sht,sthd->shd", probs, vals).to(qh.dtype)


def resolve_paged_kernel(kernel=None):
    """The serving attention variant: `kernel`, or
    ``FLAGS_serve_attention_kernel`` when None, one of PAGED_KERNELS (else
    ValueError). Nothing falls back: each name runs what it names."""
    req = kernel or str(get_flags("FLAGS_serve_attention_kernel")
                        ["FLAGS_serve_attention_kernel"] or "blockwise")
    if req not in PAGED_KERNELS:
        raise ValueError(f"unknown paged attention kernel {req!r}; expected "
                         f"one of {PAGED_KERNELS}")
    return req


def paged_decode_attention(q, k_new, v_new, k_pool, v_pool, block_tables,
                           seq_lens, active, block_size, k_scales=None,
                           v_scales=None, kernel="blockwise"):
    """One decode step of attention against one layer's paged block pool.

    q/k_new/v_new: ``[S, 1, H, D]`` this step's projections for every slot.
    k_pool/v_pool: ``[num_blocks, block_size, H, D]``, fp or int8 with
    per-block-per-head `k_scales`/`v_scales` ``[num_blocks, H]``
    (quantization/kv_cache.py). block_tables:
    ``[S, M]`` int32 dense-prefix tables padded with null block 0.
    seq_lens: ``[S]`` int32 cached tokens per slot; the new token is written
    at position ``seq_lens[s]`` and attended to. active: ``[S]`` bool;
    inactive slots write nothing into a live block (the CPU twin sends
    them to null block 0, the kernel skips them) and attend as slots of
    length 0: their outputs are garbage the engine never reads.

    One call of `paged_decode_append` a layer writes the new K/V INTO the
    pools in place and attends (on the card one launch: the paged decode
    kernel with the write as its prologue, reading q, k_new and v_new as
    the views they are; int8 pools requantize the write block and update
    its scales in place too): the JAX function returns fresh pools, the
    port edits the engine's pools, which saves a copy of every layer's pool
    per step. Returns ``(out [S, 1, H, D], k_pool, v_pool)``, plus
    ``(k_scales, v_scales)`` with int8 pools.

    `kernel` (PAGED_KERNELS; the engine resolves it once): ``"pallas"`` and
    ``"blockwise"`` take that path; ``"reference"`` writes with the plain
    write (`kv_append_reference`) and attends with the dense-gather oracle
    `_dense_gather_attention`, PyTorch ops on both devices, reached only
    when named.
    """
    if resolve_paged_kernel(kernel) == "reference":
        kv_append_reference(k_new[:, 0], v_new[:, 0], k_pool, v_pool,
                            block_tables, seq_lens, active, block_size,
                            k_scales, v_scales)
        out = _dense_gather_attention(q[:, 0], k_pool, v_pool, block_tables,
                                      torch.where(active, seq_lens, 0),
                                      block_size, k_scales, v_scales)
    else:
        out = paged_decode_append(q[:, 0], k_new[:, 0], v_new[:, 0], k_pool,
                                  v_pool, block_tables, seq_lens, active,
                                  block_size, k_scales, v_scales)
    if k_scales is not None:
        return out[:, None], k_pool, v_pool, k_scales, v_scales
    return out[:, None], k_pool, v_pool
