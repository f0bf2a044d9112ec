"""Batched low-rank adapter delta: the Hopper kernel and its plain PyTorch
twin.

No Pallas counterpart: the reference computes the multi-tenant adapter
delta with XLA einsums (`paddle_tpu/serving/tenancy.py` `_adapter_forward`,
decode: a per-slot gather and two einsums; prefill: one scalar slot). In
the port it runs inside the serving engine's captured decode and prefill
graphs, once per adapted projection (``qkv_proj``, ``out_proj``), in place
on the projection's output:

    y[n] += round_T(round_T(round_T(x[n] @ A[s, layer]) @ B[s, layer])
                    * round_T(scale[s]))          for s = idx[n] != 0

with A ``[K, L, in, r]``, B ``[K, L, r, out]`` (the model's dtype, float32
or bfloat16), scale ``[K]`` float32 and idx int32 (``[N]``, or one slot
expanded over the rows with stride 0); rows of slot 0, the base adapter,
are left untouched. Sums are fp32; round_T rounds to the model's dtype,
where the reference rounds (its einsums return the model's dtype).

On CUDA tensors `lora_delta` launches ``csrc/lora_delta.cu`` or raises; on
CPU tensors it runs `lora_delta_reference`. Launches count under
``lora_delta``.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import require_hopper
from . import _build

__all__ = ["lora_delta", "lora_delta_reference", "lora_delta_tol",
           "launches", "DTYPES"]

DTYPES = (torch.float32, torch.bfloat16)

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"lora_delta": 0}

# the kernel's shared memory: the x row and t, (in + rank) floats
_SMEM_FLOATS = 48 * 1024 // 4

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])


def _check(y, x, a, b, scale, idx, layer):
    if y.ndim != 2 or x.ndim != 2 or y.shape[0] != x.shape[0]:
        raise ValueError(f"lora_delta takes y [N, out] and x [N, in], got "
                         f"{tuple(y.shape)} and {tuple(x.shape)}")
    if a.ndim != 4 or b.ndim != 4 or a.shape[:2] != b.shape[:2] \
            or a.shape[3] != b.shape[2]:
        raise ValueError(f"lora_delta takes A [K, L, in, r] and B [K, L, r, "
                         f"out], got {tuple(a.shape)} and {tuple(b.shape)}")
    k, num_layers, d_in, _ = a.shape
    if d_in != x.shape[1] or b.shape[3] != y.shape[1]:
        raise ValueError(f"A {tuple(a.shape)} / B {tuple(b.shape)} do not "
                         f"fit x {tuple(x.shape)} / y {tuple(y.shape)}")
    if tuple(scale.shape) != (k,):
        raise ValueError(f"scale must be [{k}], got {tuple(scale.shape)}")
    if tuple(idx.shape) != (y.shape[0],):
        raise ValueError(f"idx must be [{y.shape[0]}], got "
                         f"{tuple(idx.shape)}")
    if not 0 <= layer < num_layers:
        raise ValueError(f"layer {layer} outside [0, {num_layers})")


def lora_delta_reference(y, x, a, b, scale, idx, layer):
    """Plain PyTorch twin: the reference's `_adapter_forward` arithmetic
    (gather each row's factors, x @ A, then @ B, times the scale, plus y),
    with fp32 sums and the kernel's roundings; writes y in place and
    returns it."""
    _check(y, x, a, b, scale, idx, layer)
    sel = idx.long()
    t = torch.bmm(x.float()[:, None, :], a[sel, layer].float())
    t = t.to(y.dtype).float()
    u = torch.bmm(t, b[sel, layer].float())[:, 0].to(y.dtype)
    d = u * scale[sel].to(y.dtype)[:, None]
    y.copy_(torch.where((sel != 0)[:, None], y + d, y))
    return y


def lora_delta_tol(y, x, a, b, scale, idx, layer):
    """Per-element bound on |kernel - twin| for these inputs (y before the
    delta): the two sum in other orders, so in bf16 each of t, the delta
    and the sum may round the other way once (2^-8 of its magnitude:
    |t| @ |B| x |scale| for t's, |y| + |delta| for the last two); in fp32
    the same with 2^-20 (in + r fp32 terms summed in another order)."""
    eps = 2.0 ** -8 if y.dtype == torch.bfloat16 else 2.0 ** -20
    sel = idx.long()
    t = torch.bmm(x.float()[:, None, :], a[sel, layer].float())
    b_rows = b[sel, layer].float()
    sc = scale[sel].float().abs()[:, None]
    d = torch.bmm(t, b_rows)[:, 0] * sc
    mag = torch.bmm(t.abs(), b_rows.abs())[:, 0] * sc
    bound = eps * (2 * mag + y.float().abs() + d.abs()) + 1e-30
    return torch.where((sel != 0)[:, None], bound, torch.zeros_like(bound))


def lora_delta(y, x, a, b, scale, idx, layer):
    """Add each row's adapter delta to y ``[N, out]`` in place (see the
    module docstring); returns y."""
    if y.device.type == "cpu":
        return lora_delta_reference(y, x, a, b, scale, idx, layer)
    _check(y, x, a, b, scale, idx, layer)
    n, d_out = y.shape
    k, num_layers, d_in, rank = a.shape
    if y.dtype not in DTYPES or any(t.dtype != y.dtype for t in (x, a, b)):
        raise TypeError(f"lora_delta kernel takes y, x, A and B of one dtype "
                        f"in {DTYPES}, got {y.dtype}, {x.dtype}, {a.dtype}, "
                        f"{b.dtype}")
    if scale.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"lora_delta kernel takes float32 scale and int32 "
                        f"idx, got {scale.dtype} and {idx.dtype}")
    for name, t in (("y", y), ("x", x), ("A", a), ("B", b), ("scale", scale),
                    ("idx", idx)):
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
    if y.stride(1) != 1 or x.stride(1) != 1:
        raise ValueError("lora_delta kernel needs unit inner strides of y "
                         "and x")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("lora_delta kernel needs contiguous A and B")
    if d_in + rank > _SMEM_FLOATS:
        raise ValueError(f"in + rank = {d_in + rank} floats exceed the "
                         f"kernel's 48 KB of shared memory")
    if n == 0:
        return y
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows exceed the kernel's grid")
    require_hopper(y)
    fn = _build.load("lora_delta").paddle_lora_delta
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(*(ctypes.c_void_p(t.data_ptr())
                   for t in (y, x, a, b, scale, idx)),
                 n, d_in, d_out, rank, layer, num_layers, y.stride(0),
                 x.stride(0), idx.stride(0),
                 0 if y.dtype == torch.float32 else 1,
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"lora_delta launch failed: cudaError {err}")
    launches["lora_delta"] += 1
    return y
