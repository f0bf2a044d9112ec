"""Scaled-dot-product attention and one paged decode step.

Counterpart of `paddle_tpu/nn/functional/attention.py`
(`_plain_attention`, `scaled_dot_product_attention`,
`_dense_gather_attention`, `paged_decode_attention`). Layouts are the JAX
package's: q, k, v ``[batch, seq, heads, head_dim]``.
"""
from __future__ import annotations

import math

import torch

from ...kernels.flash_attention import (DTYPES as _FLASH_DTYPES,
                                        HEAD_DIMS as _FLASH_HEAD_DIMS,
                                        flash_attention_fwd)
from ...kernels.paged_attention import paged_attention

__all__ = ["scaled_dot_product_attention", "paged_decode_attention"]

_NEG_INF = -1e30


def _plain_attention(q, k, v, mask, is_causal, scale, dropout_p=0.0):
    """softmax(QK^T * scale) V with the BOTTOM-RIGHT causal alignment: with
    cached keys (m > n), query i sits at absolute position i + (m - n)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    scores = (qt @ kt.transpose(-1, -2)) * scale            # [B, H, N, M]
    n, m = scores.shape[-2], scores.shape[-1]
    if is_causal:
        q_pos = torch.arange(n, device=q.device)[:, None] + (m - n)
        k_pos = torch.arange(m, device=q.device)[None, :]
        scores = scores.masked_fill(q_pos < k_pos, _NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, _NEG_INF)
        else:
            scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
    if dropout_p:
        probs = torch.nn.functional.dropout(probs, dropout_p, training=True)
    return (probs @ vt).transpose(1, 2)


def _flash_eligible(q, k, mask, dropout_p, is_causal):
    """The flash route: no mask, no dropout, [B, N, H, D] with D in the
    kernel's head dims, n == m when causal (the kernel's mask is top-left).
    No minimum length: the kernel masks its own ragged edges."""
    if mask is not None or dropout_p:
        return False
    if q.ndim != 4 or q.shape[-1] not in _FLASH_HEAD_DIMS \
            or q.dtype not in _FLASH_DTYPES:
        return False
    return not (is_causal and q.shape[1] != k.shape[1])


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """query/key/value: ``[batch, seq, num_heads, head_dim]``. Flash-eligible
    calls go to `flash_attention_fwd` (the CUDA kernel on the card, its
    plain twin on the CPU); the rest take the plain path."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    eff_dropout = dropout_p if training else 0.0
    if _flash_eligible(query, key, attn_mask, eff_dropout, is_causal):
        return flash_attention_fwd(query, key, value, is_causal, scale)[0]
    return _plain_attention(query, key, value, attn_mask, is_causal, scale,
                            eff_dropout)


def _dense_gather_attention(qh, k_pool, v_pool, block_tables, lens,
                            block_size):
    """The oracle: gather by block table into a dense ``[S, T, H, D]``
    context, full fp32 softmax; only the output casts back."""
    s, h, d = qh.shape
    t_max = block_tables.shape[1] * block_size
    tables = block_tables.long()
    keys = k_pool[tables].float().reshape(s, t_max, h, d)
    vals = v_pool[tables].float().reshape(s, t_max, h, d)
    scores = torch.einsum("shd,sthd->sht", qh.float(), keys) / math.sqrt(d)
    valid = torch.arange(t_max, device=qh.device)[None, :] \
        <= lens.long()[:, None]
    scores = scores.masked_fill(~valid[:, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("sht,sthd->shd", probs, vals).to(qh.dtype)


def paged_decode_attention(q, k_new, v_new, k_pool, v_pool, block_tables,
                           seq_lens, active, block_size):
    """One decode step of attention against one layer's paged block pool.

    q/k_new/v_new: ``[S, 1, H, D]`` this step's projections for every slot.
    k_pool/v_pool: ``[num_blocks, block_size, H, D]``. block_tables:
    ``[S, M]`` int32 dense-prefix tables padded with null block 0.
    seq_lens: ``[S]`` int32 cached tokens per slot; the new token is written
    at position ``seq_lens[s]`` and attended to. active: ``[S]`` bool;
    inactive slots write into null block 0 and their outputs are garbage
    the engine never reads.

    The new K/V are written INTO the pools in place (``index_put_``): the
    JAX function returns fresh pools, the port edits the engine's pools,
    which saves a copy of every layer's pool per step. Returns
    ``(out [S, 1, H, D], k_pool, v_pool)``.
    """
    s = q.shape[0]
    lens = torch.where(active, seq_lens, torch.zeros_like(seq_lens)) \
        .to(torch.int32)
    rows = torch.arange(s, device=q.device)
    lens_l = lens.long()
    # write the new token's K/V at (table[len // bs], len % bs); inactive
    # slots all target the null block (its content is never unmasked)
    write_block = torch.where(active, block_tables[rows, lens_l // block_size]
                              .long(), torch.zeros_like(lens_l))
    write_off = lens_l % block_size
    k_pool.index_put_((write_block, write_off), k_new[:, 0].to(k_pool.dtype))
    v_pool.index_put_((write_block, write_off), v_new[:, 0].to(v_pool.dtype))
    out = paged_attention(q[:, 0].contiguous(), k_pool, v_pool,
                          block_tables.to(torch.int32).contiguous(), lens,
                          block_size)
    return out[:, None], k_pool, v_pool
