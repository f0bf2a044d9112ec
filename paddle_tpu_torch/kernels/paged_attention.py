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
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..device import require_hopper
from ..quantization.kv_cache import dequantize
from . import _build

__all__ = ["paged_attention", "paged_decode_reference", "split_plan",
           "launches", "HEAD_DIMS", "DTYPES", "MAX_SPLITS",
           "MAX_SPAN_BLOCKS"]

HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_NEG_INF = -1e30

# blockwise chunking of the plain version, as in the JAX twin: chunks of
# about this many fp32 bytes per pool side, at most this many tokens
_CHUNK_TARGET_BYTES = 256 * 1024
_CHUNK_TOKENS_MAX = 512

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"paged_decode": 0, "paged_decode_int8": 0}

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
# quantized; stream
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


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
    if q.dtype not in DTYPES or (not quantized and (
            k_pool.dtype != q.dtype or v_pool.dtype != q.dtype)):
        raise TypeError(f"paged kernel takes q in {DTYPES} with pools of "
                        f"q's dtype or int8, got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
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
                 1.0 / math.sqrt(d),
                 0 if q.dtype == torch.float32 else 1, int(quantized),
                 ctypes.c_void_p(stream))
    name = "paged_decode_int8" if quantized else "paged_decode"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
    return out
