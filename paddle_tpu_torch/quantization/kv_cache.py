"""int8 KV-cache quantization for the paged serving pool, PyTorch port.

Counterpart of `paddle_tpu/quantization/kv_cache.py`. One fp32 scale per
(pool block, head): ``[num_blocks, H]`` beside each
``[num_blocks, block_size, H, D]`` int8 pool, so a cached element costs
one byte instead of two (bf16) or four (fp32) and the same pool bytes
admit about twice the streams.

Write paths, both editing the pool and its scales IN PLACE (the JAX
functions return fresh arrays; the port edits the engine's buffers, as
its fp path does):

  * `quantize_scatter` — a prefilled prompt's bulk write: the touched
    blocks' scales are reset, scatter-maxed from the written tokens'
    per-head amax, and every token quantizes under its block's scale. It
    is the plain twin of the int8 leg of the prefill's scatter kernel
    (`kernels.prefill_scatter`, every layer in one launch); `length` may
    be a device tensor, and no line reads it on the host;
  * `quantize_block_write` — the decode step's one-token append: the
    slot's write block is dequantized, the new token inserted, offsets
    past it zeroed, and the block requantized under its new per-head amax
    (exact while the scale does not grow). It is the plain twin of the
    int8 write the decode step's fused paged decode kernel makes
    (`kernels.paged_attention.paged_decode_append`).

The order of operations is the reference's (``vals * (QMAX / scale)``,
then round half to even and clip; dequantization ``q * (scale / QMAX)``
as ``q * (scale * (1 / QMAX))``), so on the same fp32 inputs the int8
levels match the JAX package's bit for bit. These are plain tensor ops in
the reference too (XLA, no Pallas kernel); on the card the port writes
a prompt with the prefill's scatter kernel, the decode token in the paged
decode kernel's prologue, in the same launch that attends
(`kernels.paged_attention.paged_decode_append`), and dequantizes in that
kernel's loads.
"""
from __future__ import annotations

import torch

__all__ = ["QMAX", "SCALE_EPS", "quantize_block_write", "quantize_scatter",
           "dequantize"]

# symmetric int8: levels in [-127, 127] (-128 is unused, so the grid is
# symmetric and dequantization a pure multiply)
QMAX = 127.0
# floor for stored scales: an all-zero block must not divide by zero
SCALE_EPS = 1e-8


def _qmax_over(scales):
    """``QMAX / scales`` as ONE correctly rounded division, as jnp does it
    (``127.0 / tensor`` in torch is ``reciprocal(tensor) * 127``, two
    roundings, which moves some int8 levels by one). The numerator is
    filled on the scales' device: a 0-dim tensor made from a Python float
    would be a host-to-device copy, which waits for the device."""
    return torch.full_like(scales, QMAX) / scales


def dequantize(values, scales):
    """int8 `values` ``[..., bs, H, D]`` under per-head `scales`
    ``[..., H]`` back to fp32 (``q * scale / 127``)."""
    return values.float() * (scales * (1.0 / QMAX))[..., None, :, None]


def quantize_block_write(pool, scales, new_vec, write_block, write_off):
    """Append one token per slot into its int8 block, requantizing the
    block under the updated per-block-per-head scale, in place.

    pool: ``[num_blocks, bs, H, D]`` int8; scales: ``[num_blocks, H]``
    fp32; new_vec: ``[S, H, D]``; write_block / write_off: ``[S]`` integer
    (inactive slots all target the null block, whose content is never
    unmasked, so which duplicate write lands there does not matter).
    Returns ``(pool, scales)``.
    """
    s, bs = new_vec.shape[0], pool.shape[1]
    write_block = write_block.long()
    write_off = write_off.long()
    rows = torch.arange(s, device=pool.device)
    blk = dequantize(pool[write_block], scales[write_block])  # [S, bs, H, D]
    blk[rows, write_off] = new_vec.float()
    # offsets past the write position are stale (a previous tenant's, or
    # prefill padding): zero them so they never inflate the block scale
    live = torch.arange(bs, device=pool.device)[None, :] <= write_off[:, None]
    blk = torch.where(live[:, :, None, None], blk, 0.0)
    new_sc = torch.clamp_min(blk.abs().amax(dim=(1, 3)), SCALE_EPS)
    q = torch.clamp(torch.round(blk * _qmax_over(new_sc)[:, None, :, None]),
                    -QMAX, QMAX).to(pool.dtype)
    pool[write_block] = q
    scales[write_block] = new_sc
    return pool, scales


def quantize_scatter(pool, scales, tok_vals, blocks, offs, block_row,
                     length):
    """Bulk-quantize a prefilled prompt's per-token K or V into the int8
    pool, in place (the quantized leg of `serving.cache.scatter_prefill`).

    tok_vals: ``[T, H, D]`` (right-padded to the prefill bucket);
    blocks / offs: ``[T]`` per-token targets (padded tokens route to the
    null block); block_row: ``[max_blocks]``, the sequence's block table,
    whose blocks get their scales RESET before the scatter-max (a freed
    block keeps its previous tenant's scale otherwise); length: the true
    prompt length, an int or a 0-dim tensor on the pool's device (compared
    on the device, never read back). Returns ``(pool, scales)``.
    """
    t = tok_vals.shape[0]
    blocks = blocks.long()
    vals = tok_vals.float()
    amax = vals.abs().amax(dim=-1)                              # [T, H]
    # floor real tokens' amax so the STORED scale is the one quantization
    # divides by; padded tokens contribute nothing
    real = torch.arange(t, device=vals.device) < length
    amax = torch.where(real[:, None], torch.clamp_min(amax, SCALE_EPS), 0.0)
    scales.index_fill_(0, block_row.long(), 0.0)
    # scatter-max over duplicate block ids: every token of a block folds
    # into its scale, deterministically (index_put_ would keep one of them)
    scales.scatter_reduce_(0, blocks[:, None].expand_as(amax), amax, "amax")
    sc_t = torch.clamp_min(scales[blocks], SCALE_EPS)           # [T, H]
    q = torch.clamp(torch.round(vals * _qmax_over(sc_t)[..., None]),
                    -QMAX, QMAX).to(pool.dtype)
    pool[blocks, offs.long()] = q
    return pool, scales
