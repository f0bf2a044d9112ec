"""The prompt's K/V scatter into the paged pools: the Hopper kernel and its
plain PyTorch twin.

Counterpart of the reference's prefill write, which is no Pallas kernel:
`paddle_tpu/serving/cache.py` `scatter_prefill` (fp pools) and, with int8
pools, `paddle_tpu/quantization/kv_cache.py` `quantize_scatter`, both
inside the jitted prefill program, where XLA fuses them. On the card
``csrc/prefill_scatter.cu`` writes every layer's K and V in one launch
(counted under ``prefill_scatter``, or ``prefill_scatter_int8`` with int8
pools); `prefill_scatter_reference` is its twin, the route CPU tensors
take.

Contract: k_pools / v_pools ``[L, num_blocks, bs, H, D]``, of the rows'
float type or int8 with fp32 scales ``[L, num_blocks, H]`` (`k_scales` /
`v_scales`); k_layers / v_layers: L per-layer ``[T, H, D]`` K and V of a
prompt right-padded to its bucket T (on the engine's path, strided views
of each layer's fused qkv output, read in place); block_row ``[M]``
integer, the sequence's block table (``M * bs >= T``); length: the true
prompt length, an int or a 0-dim integer tensor (on the card it is read
when the kernel runs, so a CUDA graph replay follows what the host
staged). Token ``p < length`` lands at block ``block_row[p // bs]``,
offset ``p % bs``; with int8 pools every block of the row first gets scale
0, a block holding real tokens then the per-head amax of those tokens
(floored at ``SCALE_EPS``), and each token quantizes under its block's
scale (`quantize_scatter`). The pools and scales are written in place;
nothing is returned.

Padded tokens: the twin writes them into null block 0 (as the reference
does); the kernel skips them and never writes block 0. Offsets past
`length` in the last block keep their old bytes on both routes. So the two
agree bit for bit on every block but 0, and every comparison leaves block
0 out.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import require_hopper
from ..quantization.kv_cache import quantize_scatter
from . import _build

__all__ = ["prefill_scatter", "prefill_scatter_reference", "scatter_bytes",
           "run", "launches", "DTYPES", "MAX_LAYERS", "MAX_HEADS"]

DTYPES = (torch.float32, torch.bfloat16)
# the source's kMaxLayers and kMaxHeads (checked when the library loads)
MAX_LAYERS = 128
MAX_HEADS = 256

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"prefill_scatter": 0, "prefill_scatter_int8": 0}

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def prefill_scatter_reference(k_pools, v_pools, k_layers, v_layers,
                              block_row, length, block_size, k_scales=None,
                              v_scales=None):
    """Plain PyTorch twin: padded tokens routed to null block 0, then one
    `index_put_` a layer and pool (fp) or `quantize_scatter` (int8)."""
    t_bucket = k_layers[0].shape[0]
    pidx = torch.arange(t_bucket, device=k_pools.device)
    blocks = torch.where(pidx < length,
                         block_row.long()[pidx // block_size],
                         torch.zeros_like(pidx))
    offs = pidx % block_size
    if k_scales is not None:
        for layer, (k, v) in enumerate(zip(k_layers, v_layers)):
            quantize_scatter(k_pools[layer], k_scales[layer], k, blocks, offs,
                             block_row, length)
            quantize_scatter(v_pools[layer], v_scales[layer], v, blocks, offs,
                             block_row, length)
        return
    for layer, (k, v) in enumerate(zip(k_layers, v_layers)):
        k_pools[layer].index_put_((blocks, offs), k.to(k_pools.dtype))
        v_pools[layer].index_put_((blocks, offs), v.to(v_pools.dtype))


def scatter_bytes(length, layers, heads, head_dim, elem, int8, blocks):
    """Bytes one scatter must move: each real token's K and V row of every
    layer read once (`elem` bytes a value) and written once (a byte a value
    with int8 pools, plus an fp32 scale a layer, pool, head and block of
    the row, `blocks` being the row's non-null entries), and the row."""
    values = 2 * layers * length * heads * head_dim
    written = values * (1 if int8 else elem)
    scales = 2 * layers * blocks * heads * 4 if int8 else 0
    return values * elem + written + scales + blocks * 4 + 4


def _check(k_pools, v_pools, k_layers, v_layers, block_row, block_size,
           k_scales, v_scales):
    """The contract's shapes, on both routes."""
    if k_pools.ndim != 5 or v_pools.shape != k_pools.shape \
            or k_pools.shape[2] != block_size:
        raise ValueError(f"pools [L, num_blocks, {block_size}, H, D] "
                         f"expected, got {tuple(k_pools.shape)}, "
                         f"{tuple(v_pools.shape)}")
    n_layers, num_blocks, _, h, d = k_pools.shape
    if len(k_layers) != n_layers or len(v_layers) != n_layers:
        raise ValueError(f"{n_layers} layers of K and V expected, got "
                         f"{len(k_layers)} and {len(v_layers)}")
    t = k_layers[0].shape[0]
    for x in (*k_layers, *v_layers):
        if tuple(x.shape) != (t, h, d):
            raise ValueError(f"per-layer K/V [{t}, {h}, {d}] expected, got "
                             f"{tuple(x.shape)}")
    if block_row.ndim != 1 or block_row.shape[0] * block_size < t:
        raise ValueError(f"block_row [M] with M * {block_size} >= {t} "
                         f"expected, got {tuple(block_row.shape)}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if k_scales is not None:
        want = (n_layers, num_blocks, h)
        if k_pools.dtype != torch.int8:
            raise TypeError(f"scales come with int8 pools, got "
                            f"{k_pools.dtype}")
        if tuple(k_scales.shape) != want or tuple(v_scales.shape) != want:
            raise ValueError(f"scales {want} expected, got "
                             f"{tuple(k_scales.shape)}, "
                             f"{tuple(v_scales.shape)}")


def _check_launch(k_pools, v_pools, k_layers, v_layers, block_row, length,
                  k_scales, v_scales):
    """What the kernel takes beyond the contract: rows in DTYPES of one
    row stride with contiguous 16-byte aligned [H, D] rows and head_dim a
    whole number of 16-byte vectors, pools of the rows' type (or int8 with
    fp32 scales), contiguous; an int32 block row and length on the
    pools' device; at most MAX_LAYERS layers and MAX_HEADS heads."""
    quantized = k_scales is not None
    dtype, dev = k_layers[0].dtype, k_pools.device
    n_layers, _, _, h, d = k_pools.shape
    if dtype not in DTYPES:
        raise TypeError(f"prefill_scatter kernel takes rows in {DTYPES}, got "
                        f"{dtype}")
    if not quantized and k_pools.dtype != dtype:
        raise TypeError(f"prefill_scatter kernel takes pools of the rows' "
                        f"type ({dtype}) or int8, got {k_pools.dtype}")
    if quantized and (k_scales.dtype != torch.float32
                      or v_scales.dtype != torch.float32):
        raise TypeError(f"scales must be float32, got {k_scales.dtype}, "
                        f"{v_scales.dtype}")
    if n_layers > MAX_LAYERS or h > MAX_HEADS:
        raise ValueError(f"prefill_scatter kernel takes at most {MAX_LAYERS} "
                         f"layers and {MAX_HEADS} heads, got {n_layers}, {h}")
    elem = k_layers[0].element_size()
    if (d * elem) % 16:
        raise ValueError(f"prefill_scatter kernel needs head_dim x "
                         f"{elem} bytes a multiple of 16, got {d}")
    stride = k_layers[0].stride(0)
    for x in (*k_layers, *v_layers):
        if x.dtype != dtype or x.device != dev:
            raise ValueError(f"K/V rows of one type on {dev}, got {x.dtype} "
                             f"on {x.device}")
        if x.stride() != (stride, d, 1):
            raise ValueError(f"prefill_scatter kernel reads rows of strides "
                             f"({stride}, {d}, 1), got {x.stride()}")
        if x.data_ptr() % 16 or (stride * elem) % 16:
            raise ValueError("prefill_scatter kernel needs 16-byte aligned "
                             "K/V rows")
    if block_row.dtype != torch.int32 or length.dtype != torch.int32:
        raise TypeError(f"block_row and length must be int32, got "
                        f"{block_row.dtype}, {length.dtype}")
    if length.numel() != 1:
        raise ValueError(f"length must be one element, got "
                         f"{tuple(length.shape)}")
    scales = (("k_scales", k_scales), ("v_scales", v_scales)) \
        if quantized else ()
    for name, x in (("k_pools", k_pools), ("v_pools", v_pools),
                    ("block_row", block_row), *scales):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, pools on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"prefill_scatter kernel needs a contiguous "
                             f"{name}")
    if length.device != dev:
        raise ValueError(f"length is on {length.device}, pools on {dev}")


_LIB = []


def _lib_fn():
    if not _LIB:
        lib = _build.load("prefill_scatter")
        for name, want in (("paddle_prefill_scatter_max_layers", MAX_LAYERS),
                           ("paddle_prefill_scatter_max_heads", MAX_HEADS)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            if fn() != want:
                raise RuntimeError(f"{name}() is {fn()}, the wrapper "
                                   f"expects {want}")
        _LIB.append(lib.paddle_prefill_scatter)
    return _LIB[0]


@torch.no_grad()
def prefill_scatter(k_pools, v_pools, k_layers, v_layers, block_row, length,
                    block_size, k_scales=None, v_scales=None):
    """Write a prompt's K/V of every layer into the pools, in place (see
    the module docstring for the contract). On CPU tensors the twin runs;
    on CUDA tensors one kernel launch, or an error. A Python int `length`
    is filled into a device scalar first (no host-to-device copy)."""
    block_size = int(block_size)
    _check(k_pools, v_pools, k_layers, v_layers, block_row, block_size,
           k_scales, v_scales)
    if k_pools.device.type == "cpu":
        prefill_scatter_reference(k_pools, v_pools, k_layers, v_layers,
                                  block_row, length, block_size, k_scales,
                                  v_scales)
        return
    if not isinstance(length, torch.Tensor):
        length = torch.full((), int(length), dtype=torch.int32,
                            device=k_pools.device)
    _check_launch(k_pools, v_pools, k_layers, v_layers, block_row, length,
                  k_scales, v_scales)
    require_hopper(k_pools)
    err = run(_lib_fn(), k_pools, v_pools, k_layers, v_layers, block_row,
              length, block_size, k_scales, v_scales)
    name = "prefill_scatter_int8" if k_scales is not None \
        else "prefill_scatter"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1


def run(fn, k_pools, v_pools, k_layers, v_layers, block_row, length,
        block_size, k_scales=None, v_scales=None):
    """One launch of `fn` (``paddle_prefill_scatter`` of this source or
    another of the same C interface) on checked CUDA tensors, counting
    nothing: its cudaError."""
    n_layers, num_blocks, _, h, d = k_pools.shape
    quantized = k_scales is not None
    ptrs = ctypes.c_void_p * n_layers
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(k_pools.device):
        stream = torch.cuda.current_stream().cuda_stream
        return fn(n_layers, ptrs(*[x.data_ptr() for x in k_layers]),
                  ptrs(*[x.data_ptr() for x in v_layers]),
                  ctypes.c_void_p(k_pools.data_ptr()),
                  ctypes.c_void_p(v_pools.data_ptr()),
                  ctypes.c_void_p(k_scales.data_ptr() if quantized else 0),
                  ctypes.c_void_p(v_scales.data_ptr() if quantized else 0),
                  ctypes.c_void_p(block_row.data_ptr()),
                  ctypes.c_void_p(length.data_ptr()), block_row.shape[0],
                  k_layers[0].shape[0], h, d, block_size, num_blocks,
                  k_layers[0].stride(0),
                  0 if k_layers[0].dtype == torch.float32 else 1,
                  ctypes.c_void_p(stream))
