"""The decode step's KV append: the plain PyTorch version of the write
that the fused paged decode kernel makes before it attends.

Counterpart of the write half of `paddle_tpu/nn/functional/attention.py`
`paged_decode_attention` (the fp ``pool.at[write_block, write_off].set``)
and of `paddle_tpu/quantization/kv_cache.py` `quantize_block_write` (int8
pools). The reference leaves both to XLA, which fuses them into its one
compiled decode step; there is no Pallas kernel. On the card the write is
the prologue of ``csrc/paged_decode.cu``'s kernel (`paged_attention.
paged_decode_append`, one launch a layer for the write and the
attention); `kv_append_reference` is its write half's twin, and the CPU
route of `paged_decode_append` runs it.

Contract: k_new / v_new ``[S, H, D]`` this step's K and V of every slot,
any strides; k_pool / v_pool ``[num_blocks, bs, H, D]`` one layer's pools,
of a float type (the new rows are cast to it, as the reference's
``.astype(k_pool.dtype)``: round to nearest even) or int8 with fp32 scales ``[num_blocks, H]`` (`k_scales`
/ `v_scales`); block_tables ``[S, M]`` int32, seq_lens ``[S]`` int32,
active ``[S]`` bool. Slot s writes at position ``seq_lens[s]``: block
``block_tables[s, seq_lens[s] // bs]``, offset ``seq_lens[s] % bs``. With
int8 pools the write block is dequantized, the new vector inserted, the
offsets after it zeroed and the block requantized under its new per-head
amax (`quantize_block_write`). The pools and scales are written in place;
nothing is returned.

Inactive slots: the twin writes their vectors into null block 0 (with
duplicate targets, as the reference does); the kernel skips them. Block
0 is never read unmasked, so the two differ only there, and every
comparison leaves block 0 out. Active slots never share a write block
(each slot owns its blocks: the port has no prefix cache), so the kernel
has no write race.
"""
from __future__ import annotations

import torch

from ..quantization.kv_cache import quantize_block_write

__all__ = ["kv_append_reference"]

# the float types a write may cast between (an engine's pools of another
# float type than its model's)
_CASTS = {torch.float32, torch.bfloat16, torch.float16}


def _check(k_new, v_new, k_pool, v_pool, block_tables, seq_lens, active,
           block_size, k_scales, v_scales):
    if k_new.ndim != 3 or v_new.shape != k_new.shape:
        raise ValueError(f"kv_append takes k_new and v_new [S, H, D], got "
                         f"{tuple(k_new.shape)}, {tuple(v_new.shape)}")
    s, h, d = k_new.shape
    if k_pool.ndim != 4 or v_pool.shape != k_pool.shape \
            or k_pool.shape[1] != block_size or k_pool.shape[2:] != (h, d):
        raise ValueError(f"pools [num_blocks, {block_size}, {h}, {d}] "
                         f"expected, got {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != s \
            or tuple(seq_lens.shape) != (s,) or tuple(active.shape) != (s,):
        raise ValueError(f"block_tables [S, M], seq_lens [S] and active [S] "
                         f"expected for S={s}, got "
                         f"{tuple(block_tables.shape)}, "
                         f"{tuple(seq_lens.shape)}, {tuple(active.shape)}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32 \
            or active.dtype != torch.bool:
        raise TypeError(f"block_tables and seq_lens must be int32 and active "
                        f"bool, got {block_tables.dtype}, {seq_lens.dtype}, "
                        f"{active.dtype}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    scales = ()
    if k_scales is not None:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError(f"scales come with int8 pools, got "
                            f"{k_pool.dtype}, {v_pool.dtype}")
        want = (k_pool.shape[0], h)
        if tuple(k_scales.shape) != want or tuple(v_scales.shape) != want:
            raise ValueError(f"scales [num_blocks, H] = {want} expected, "
                             f"got {tuple(k_scales.shape)}, "
                             f"{tuple(v_scales.shape)}")
        if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
            raise TypeError(f"scales must be float32, got {k_scales.dtype}, "
                            f"{v_scales.dtype}")
        if not (k_new.dtype.is_floating_point and v_new.dtype == k_new.dtype):
            raise TypeError(f"k_new and v_new must share one float type, got "
                            f"{k_new.dtype}, {v_new.dtype}")
        scales = (("k_scales", k_scales), ("v_scales", v_scales))
    elif not (k_pool.dtype == v_pool.dtype and k_new.dtype == v_new.dtype
              and k_pool.dtype.is_floating_point
              and (k_new.dtype == k_pool.dtype
                   or {k_new.dtype, k_pool.dtype} <= _CASTS)):
        raise TypeError(f"fp pools take k_new and v_new of their own float "
                        f"type, or another of fp32, bf16 and fp16 (cast on "
                        f"the write), got {k_new.dtype}, {v_new.dtype} into "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    for name, t in (("k_new", k_new), ("v_new", v_new), ("k_pool", k_pool),
                    ("v_pool", v_pool), ("block_tables", block_tables),
                    ("seq_lens", seq_lens), ("active", active), *scales):
        if t.device != k_pool.device:
            raise ValueError(f"{name} is on {t.device}, k_pool on "
                             f"{k_pool.device}")
        if name not in ("k_new", "v_new") and not t.is_contiguous():
            raise ValueError(f"kv_append needs a contiguous {name}")


def kv_append_reference(k_new, v_new, k_pool, v_pool, block_tables,
                        seq_lens, active, block_size, k_scales=None,
                        v_scales=None):
    """Plain PyTorch twin: the write positions by index arithmetic, then
    ``index_put_`` (fp pools) or `quantize_block_write` (int8 pools) for
    each pool; inactive slots write into null block 0."""
    _check(k_new, v_new, k_pool, v_pool, block_tables, seq_lens, active,
           block_size, k_scales, v_scales)
    s = k_new.shape[0]
    lens = torch.where(active, seq_lens, 0).long()
    rows = torch.arange(s, device=k_new.device)
    write_block = torch.where(active, block_tables[rows, lens // block_size]
                              .long(), 0)
    write_off = lens % block_size
    if k_scales is not None:
        quantize_block_write(k_pool, k_scales, k_new, write_block, write_off)
        quantize_block_write(v_pool, v_scales, v_new, write_block, write_off)
    else:
        k_pool.index_put_((write_block, write_off), k_new.to(k_pool.dtype))
        v_pool.index_put_((write_block, write_off), v_new.to(v_pool.dtype))

