"""Paged decode attention: the Hopper kernel and its plain PyTorch twin.

Counterpart of `paddle_tpu/kernels/pallas/paged_attention.py`
(`_decode_kernel` / `pallas_paged_attention`, and the pure-JAX
`blockwise_paged_attention` whose torch copy is `paged_decode_reference`).

Contract (shared by both): q ``[S, H, D]`` this step's queries;
k_pool/v_pool ``[num_blocks, block_size, H, D]`` one layer's pool;
block_tables ``[S, M]`` int32; lens ``[S]`` int32 EFFECTIVE lengths
(position p attends iff p <= lens[s]; inactive slots pass 0). Returns
``[S, H, D]`` in q's dtype. Scores, the softmax recurrence and the output
accumulator are fp32 whatever the input type; masked positions contribute
exactly zero probability. With int8 pools pass their fp32 scales
``[num_blocks, H]`` as `k_scales` / `v_scales`: both versions dequantize
in the load (``k * (scale * (1 / 127))``, quantization/kv_cache.py), so
fp K/V exist only per chunk (twin) or in registers (kernel).

On CUDA tensors `paged_attention` launches ``csrc/paged_decode.cu`` or
raises; on CPU tensors it runs `paged_decode_reference`. The kernel splits
each slot's context across the CTAs of one cluster: `split_plan` chooses,
from shapes alone, how many table entries each CTA takes, and the first
CTA of the cluster combines their partial softmaxes from shared memory.
Nothing is read back from the device and nothing is allocated beside the
output, so a decode step stays free of host syncs. Launches count once
per call under ``paged_decode`` (fp pools) and ``paged_decode_int8``.

q and the pools are each float32, bfloat16 or float16, in any pair (an
engine's float ``kv_dtype`` other than the model's): both versions read the
pools as fp32 for the scores and the softmax and return q's dtype; the
decode write casts the new rows to the pools' type (round to nearest even;
past 65504 to inf in float16 pools), as the reference's ``.astype`` does.
The kernel has an instantiation for every pair (and for int8 pools under
each q type); the C entry takes the pools' own type code (`_dtype`).

`paged_decode_append` is the serving decode step's entry: the same kernel
built with the decode write folded in (one launch a layer writes this
step's K and V rows of every active slot, then attends). It takes q, k_new
and v_new as the strided views of the fused QKV projection and the active
flags beside the lengths; its plain twin is `kv_append_reference` then
`paged_decode_reference` with ``where(active, seq_lens, 0)``. Launches
count under ``paged_decode_append``, ``paged_decode_append_int8`` and, over
pools of another float type, ``paged_decode_append_to_bf16`` /
``_to_fp32`` / ``_to_fp16`` (`append_name`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..device import require_hopper
from ..ops import numerics
from ..quantization.kv_cache import dequantize
from . import _build
from ._dtype import FLOAT_DTYPES, SHORT_NAMES, dtype_code, pool_code
from .kv_append import _check as _check_write
from .kv_append import kv_append_reference

__all__ = ["paged_attention", "paged_decode_append", "append_name",
           "paged_decode_reference", "split_plan", "launches", "HEAD_DIMS",
           "DTYPES", "MAX_SPLITS", "MAX_SPAN_BLOCKS",
           "MAX_INT8_BLOCK_LEVELS"]

HEAD_DIMS = (64, 128)
DTYPES = FLOAT_DTYPES
_NEG_INF = -1e30

# blockwise chunking of the plain version, as in the JAX twin: chunks of
# about this many fp32 bytes per pool side, at most this many tokens
_CHUNK_TARGET_BYTES = 256 * 1024
_CHUNK_TOKENS_MAX = 512

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"paged_decode": 0, "paged_decode_int8": 0,
            "paged_decode_append": 0, "paged_decode_append_int8": 0,
            "paged_decode_append_to_bf16": 0,
            "paged_decode_append_to_fp32": 0,
            "paged_decode_append_to_fp16": 0}

# the kernel's split: the CTAs of one (slot, head) share its live positions
# in whole table entries, each at most about SPAN_TOKENS of a full table,
# so n_split = ceil(M / (SPAN_TOKENS / bs)); they form one cluster, at
# most MAX_SPLITS CTAs where every Hopper launch accepts it (longer
# tables take longer spans), and a span holds at most MAX_SPAN_BLOCKS
# entries (staged in shared memory)
SPAN_TOKENS = 256
MAX_SPLITS = 8
MAX_SPAN_BLOCKS = 512
# q, k_pool, v_pool, k_scales, v_scales, tables, lens, out; slots, heads,
# head_dim, max_blocks, block_size, span_blocks, n_split; scale; dtype,
# pools (the pools' type code); stream
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# q, k_new, v_new, k_pool, v_pool, k_scales, v_scales, tables, lens,
# active, out, strides; slots, heads, head_dim, max_blocks, block_size,
# num_blocks, span_blocks, n_split; scale; dtype, pools; stream
_APPEND_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p])
# the fused write keeps an int8 block slice (block_size x head_dim levels a
# pool) in registers, 16 a thread of 128 at most
MAX_INT8_BLOCK_LEVELS = 2048


def _check(q, k_pool, v_pool, block_tables, lens, block_size, k_scales,
           v_scales):
    if q.ndim != 3 or k_pool.ndim != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged attention takes q [S, H, D] and pools "
                         f"[num_blocks, bs, H, D], got q {tuple(q.shape)}, "
                         f"k_pool {tuple(k_pool.shape)}, "
                         f"v_pool {tuple(v_pool.shape)}")
    s, h, d = q.shape
    if k_pool.shape[1] != block_size or k_pool.shape[2:] != (h, d):
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match "
                         f"block_size {block_size} and q {tuple(q.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != s \
            or tuple(lens.shape) != (s,):
        raise ValueError(f"block_tables [S, M] and lens [S] expected for "
                         f"S={s}, got {tuple(block_tables.shape)}, "
                         f"{tuple(lens.shape)}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if k_scales is not None:
        want = (k_pool.shape[0], h)
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError(f"scales come with int8 pools, got "
                            f"{k_pool.dtype}, {v_pool.dtype}")
        if tuple(k_scales.shape) != want or tuple(v_scales.shape) != want:
            raise ValueError(f"scales [num_blocks, H] = {want} expected, "
                             f"got {tuple(k_scales.shape)}, "
                             f"{tuple(v_scales.shape)}")


def _pool_kind(q, k_pool, v_pool, quantized):
    """The kernel's code for the pools' own type (`_dtype.pool_code`: 0
    fp32, 1 bf16, 2 f16, 3 int8 with scales). Raises TypeError for what
    the kernel does not take."""
    if q.dtype not in DTYPES:
        raise TypeError(f"paged kernel takes q in {DTYPES}, got {q.dtype}")
    if k_pool.dtype != v_pool.dtype:
        raise TypeError(f"K and V pools of one type, got {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if quantized:
        return pool_code(torch.int8)
    if k_pool.dtype not in DTYPES:
        raise TypeError(f"paged kernel takes pools in {DTYPES} or int8, got "
                        f"{k_pool.dtype}")
    return pool_code(k_pool.dtype)


def append_name(q_dtype, pool_dtype):
    """The launch counter of `paged_decode_append` for q over pools of
    `pool_dtype`: ``paged_decode_append`` (q's dtype),
    ``paged_decode_append_int8``, or ``paged_decode_append_to_bf16`` /
    ``_to_fp32`` / ``_to_fp16`` (pools of another float type)."""
    if pool_dtype == torch.int8:
        return "paged_decode_append_int8"
    if pool_dtype == q_dtype:
        return "paged_decode_append"
    return "paged_decode_append_to_" + SHORT_NAMES[pool_dtype]


def split_plan(max_blocks, block_size):
    """How the kernel splits each slot's context, from the table's shape
    alone: ``(span_blocks, n_split)``: ``n_split = ceil(max_blocks / span_blocks)``
    (at most MAX_SPLITS) CTAs per (slot, head), each taking at most
    `span_blocks` table entries. It never sees the lengths: on the device
    split i of slot s takes entries ``[i e, (i + 1) e)`` with ``e =
    min(span_blocks, ceil(ceil((lens[s] + 1) / n_split) / block_size))``,
    and a split starting past lens[s] does no loads."""
    if max_blocks > MAX_SPLITS * MAX_SPAN_BLOCKS:
        raise ValueError(f"paged kernel takes at most {MAX_SPLITS} x "
                         f"{MAX_SPAN_BLOCKS} table entries, got {max_blocks}")
    span = min(max(1, SPAN_TOKENS // block_size, -(-max_blocks // MAX_SPLITS)),
               max_blocks)
    return span, -(-max_blocks // span)


def paged_decode_reference(q, k_pool, v_pool, block_tables, lens, block_size,
                           k_scales=None, v_scales=None, chunk_blocks=None):
    """Plain PyTorch twin: online softmax over the block table, one chunk of
    pool blocks at a time (a torch copy of `blockwise_paged_attention`)."""
    _check(q, k_pool, v_pool, block_tables, lens, block_size, k_scales,
           v_scales)
    s, h, d = q.shape
    m = block_tables.shape[1]
    bs = int(block_size)
    if chunk_blocks is None:
        tokens = min(max(_CHUNK_TARGET_BYTES // (h * d * 4), bs),
                     _CHUNK_TOKENS_MAX)
        chunk_blocks = max(1, tokens // bs)
    chunk_blocks = min(int(chunk_blocks), m)
    n_chunks = -(-m // chunk_blocks)
    tables = block_tables.long()
    pad = n_chunks * chunk_blocks - m
    if pad:
        # padded entries read the null block; their positions exceed every
        # possible length, so the mask kills them
        tables = torch.nn.functional.pad(tables, (0, pad))
    q32 = q.float() * (1.0 / math.sqrt(d))
    t_chunk = chunk_blocks * bs
    offs = torch.arange(t_chunk, device=q.device)
    lens_l = lens.long()
    acc = torch.zeros((s, h, d), dtype=torch.float32, device=q.device)
    mx = torch.full((s, h), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((s, h), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        bids = tables[:, ci * chunk_blocks:(ci + 1) * chunk_blocks]
        if k_scales is not None:
            kc = dequantize(k_pool[bids], k_scales[bids])
            vc = dequantize(v_pool[bids], v_scales[bids])
        else:
            kc = k_pool[bids].float()
            vc = v_pool[bids].float()
        kc = kc.reshape(s, t_chunk, h, d)
        vc = vc.reshape(s, t_chunk, h, d)
        scores = torch.einsum("shd,sthd->sht", q32, kc)
        valid = (ci * t_chunk + offs)[None, :] <= lens_l[:, None]   # [S, t]
        scores = scores.masked_fill(~valid[:, None, :], _NEG_INF)
        m_new = torch.maximum(mx, scores.amax(dim=-1))
        # explicit zero for masked positions: a fully masked chunk must not
        # leak exp(NEG - NEG) == 1 into the row sums
        p = torch.where(valid[:, None, :],
                        torch.exp(scores - m_new[..., None]),
                        torch.zeros((), dtype=torch.float32, device=q.device))
        alpha = torch.exp(mx - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("sht,sthd->shd", p, vc)
        mx = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def paged_attention(q, k_pool, v_pool, block_tables, lens, block_size,
                    k_scales=None, v_scales=None):
    """One decode step of attention over the paged pool (see the module
    docstring for the contract)."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, block_tables, lens,
                                      block_size, k_scales, v_scales)
    _check(q, k_pool, v_pool, block_tables, lens, block_size, k_scales,
           v_scales)
    s, h, d = q.shape
    m = block_tables.shape[1]
    quantized = k_scales is not None
    kind = _pool_kind(q, k_pool, v_pool, quantized)
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("block_tables and lens must be int32")
    if quantized and (k_scales.dtype != torch.float32
                      or v_scales.dtype != torch.float32):
        raise TypeError(f"scales must be float32, got {k_scales.dtype}, "
                        f"{v_scales.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged kernel takes head_dim in {HEAD_DIMS}, got {d}")
    scales = (("k_scales", k_scales), ("v_scales", v_scales)) \
        if quantized else ()
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lens", lens),
                    *scales):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged kernel needs a contiguous {name}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged kernel needs 16-byte aligned {name}")
    require_hopper(q)
    span, n_split = split_plan(m, int(block_size))
    lib = _build.load("paged_decode")
    fn = lib.paddle_paged_decode
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty((s, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(ctypes.c_void_p(q.data_ptr()),
                 ctypes.c_void_p(k_pool.data_ptr()),
                 ctypes.c_void_p(v_pool.data_ptr()),
                 ctypes.c_void_p(k_scales.data_ptr() if quantized else 0),
                 ctypes.c_void_p(v_scales.data_ptr() if quantized else 0),
                 ctypes.c_void_p(block_tables.data_ptr()),
                 ctypes.c_void_p(lens.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()),
                 s, h, d, m, int(block_size), span, n_split,
                 1.0 / math.sqrt(d), dtype_code(q.dtype), kind,
                 ctypes.c_void_p(stream))
    name = "paged_decode_int8" if quantized else "paged_decode"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
    numerics.check(name, out)
    return out


def _check_append(q, k_new, v_new, k_pool, v_pool, block_tables, seq_lens,
                  active, block_size, k_scales, v_scales):
    """The fused entry's contract, on both routes: the write's (`kv_append`
    `_check`), the attention's, and one float type for q, k_new and
    v_new."""
    _check_write(k_new, v_new, k_pool, v_pool, block_tables, seq_lens, active,
                 block_size, k_scales, v_scales)
    _check(q, k_pool, v_pool, block_tables, seq_lens, block_size, k_scales,
           v_scales)
    if q.dtype != k_new.dtype:
        raise TypeError(f"q, k_new and v_new must share one float type, got "
                        f"{q.dtype}, {k_new.dtype}, {v_new.dtype}")


def _check_append_launch(q, k_new, v_new, k_pool, v_pool, block_size,
                         quantized):
    """What the fused kernel takes beyond the contract: its types (returns
    `_pool_kind`'s code) and head dims, q on the pools' device by rows of unit stride at 16-byte aligned
    addresses (its 16-byte loads), 16-byte aligned pools, and with int8
    pools at most MAX_INT8_BLOCK_LEVELS levels a block slice."""
    d = q.shape[2]
    kind = _pool_kind(q, k_pool, v_pool, quantized)
    if d not in HEAD_DIMS:
        raise ValueError(f"paged kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if q.device != k_pool.device:
        raise ValueError(f"q is on {q.device}, k_pool on {k_pool.device}")
    if q.stride(2) != 1:
        raise ValueError(f"paged kernel reads q by rows of unit stride, got "
                         f"strides {q.stride()}")
    elem = q.element_size()
    if q.data_ptr() % 16 or (q.stride(0) * elem) % 16 \
            or (q.stride(1) * elem) % 16:
        raise ValueError(f"paged kernel needs q's rows 16-byte aligned, got "
                         f"strides {q.stride()} at offset "
                         f"{q.data_ptr() % 16} of 16")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged kernel needs 16-byte aligned {name}")
    if quantized and block_size * d > MAX_INT8_BLOCK_LEVELS:
        raise ValueError(f"the fused int8 write takes block_size x head_dim "
                         f"<= {MAX_INT8_BLOCK_LEVELS}, got {block_size} x {d}")
    return kind


def paged_decode_append(q, k_new, v_new, k_pool, v_pool, block_tables,
                        seq_lens, active, block_size, k_scales=None,
                        v_scales=None):
    """One layer's decode step: write this step's K and V rows of every
    active slot at position ``seq_lens[s]`` of its table into the pools (in
    place; int8 pools requantize the write block and its scales, as
    `quantize_block_write` does), then attend over positions ``<=
    seq_lens[s]`` (0 for inactive slots). q, k_new, v_new: ``[S, H, D]``
    of one float type, any strides on the CPU; the rest as `paged_attention`
    and `kv_append_reference`. Returns out ``[S, H, D]`` in q's dtype.

    On CUDA tensors it launches ``paddle_paged_decode_append`` once or
    raises; on CPU tensors it runs the plain composition. The kernel skips
    inactive slots where the twin writes their rows into null block 0;
    block 0 is never read unmasked."""
    _check_append(q, k_new, v_new, k_pool, v_pool, block_tables, seq_lens,
                  active, block_size, k_scales, v_scales)
    if q.device.type == "cpu":
        kv_append_reference(k_new, v_new, k_pool, v_pool, block_tables,
                            seq_lens, active, block_size, k_scales, v_scales)
        return paged_decode_reference(q, k_pool, v_pool, block_tables,
                                      torch.where(active, seq_lens, 0),
                                      block_size, k_scales, v_scales)
    quantized = k_scales is not None
    kind = _check_append_launch(q, k_new, v_new, k_pool, v_pool,
                                int(block_size), quantized)
    require_hopper(q)
    s, h, d = q.shape
    m = block_tables.shape[1]
    span, n_split = split_plan(m, int(block_size))
    lib = _build.load("paged_decode")
    fn = lib.paddle_paged_decode_append
    fn.argtypes = _APPEND_ARGTYPES
    fn.restype = ctypes.c_int
    strides = (ctypes.c_int64 * 8)(*q.stride()[:2], *k_new.stride(),
                                   *v_new.stride())
    out = torch.empty((s, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(ctypes.c_void_p(q.data_ptr()),
                 ctypes.c_void_p(k_new.data_ptr()),
                 ctypes.c_void_p(v_new.data_ptr()),
                 ctypes.c_void_p(k_pool.data_ptr()),
                 ctypes.c_void_p(v_pool.data_ptr()),
                 ctypes.c_void_p(k_scales.data_ptr() if quantized else 0),
                 ctypes.c_void_p(v_scales.data_ptr() if quantized else 0),
                 ctypes.c_void_p(block_tables.data_ptr()),
                 ctypes.c_void_p(seq_lens.data_ptr()),
                 ctypes.c_void_p(active.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()),
                 ctypes.cast(strides, ctypes.c_void_p),
                 s, h, d, m, int(block_size), k_pool.shape[0], span, n_split,
                 1.0 / math.sqrt(d), dtype_code(q.dtype), kind,
                 ctypes.c_void_p(stream))
    name = append_name(q.dtype, k_pool.dtype)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
    numerics.check(name, out)
    return out
