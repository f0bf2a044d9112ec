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
are left untouched. The twin's sums are fp32 (the kernel's tile form sums
x @ A in fp64, `lora_delta_exact`); round_T rounds to the model's dtype,
where the reference rounds (its einsums return the model's dtype).

On CUDA tensors `lora_delta` launches ``csrc/lora_delta.cu`` or raises; on
CPU tensors it runs `lora_delta_reference`. Launches count under
``lora_delta``, once a call. The kernel has two forms, which `lora_form`
picks from idx's stride alone (never from its values, so a captured graph
stays right whatever slots it later reads):

  * ``"row"`` (decode: a slot a row): a grid of rows x 256-column chunks;
    each CTA recomputes its row's ``x @ A`` and owns 16-byte vectors of
    output columns;
  * ``"tile"`` (prefill: one slot expanded over the rows with stride 0):
    16-row tiles x column tiles; each CTA computes its tile's
    ``X @ A`` once (bf16 on the tensor cores, fp32 on the FMA units) and
    reads A and B once a tile.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import require_hopper
from . import _build

__all__ = ["lora_delta", "lora_delta_reference", "lora_delta_exact",
           "lora_delta_tol", "lora_form", "smem_bytes", "run", "launches",
           "DTYPES", "FORMS"]

DTYPES = (torch.float32, torch.bfloat16)

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"lora_delta": 0}

FORMS = ("row", "tile")

# dynamic shared memory a launch may take without an attribute
SMEM_LIMIT = 48 * 1024

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])


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


def lora_delta_exact(y, x, a, b, scale, idx, layer):
    """The twin's arithmetic with fp64 sums: each of t, u = t @ B, the
    scaled delta and the sum rounded to y's dtype once from the exact
    value (through fp32, as the kernel rounds). A new tensor; y is read
    only. Where the twin's own fp32 sums leave `lora_delta_tol` of this,
    a check holds the kernel against this instead."""
    _check(y, x, a, b, scale, idx, layer)
    sel = idx.long()
    t = torch.bmm(x.double()[:, None, :], a[sel, layer].double())
    t = t.float().to(y.dtype).double()
    u = torch.bmm(t, b[sel, layer].double())[:, 0].float().to(y.dtype)
    d = u * scale[sel].to(y.dtype)[:, None]
    return torch.where((sel != 0)[:, None], y + d, y)


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


def lora_form(idx):
    """The kernel's form for row slots `idx` ``[N]``: ``"tile"`` where one
    slot is expanded over the rows (stride 0: every row reads idx[0]),
    else ``"row"``. Shapes and strides only, never the slots' values."""
    return "tile" if idx.stride(0) == 0 else "row"


def smem_bytes(form, d_in, rank):
    """The dynamic shared memory a launch of `form` takes: the row form
    the x row, eight warps' sums of x @ A and t, (in + 9 rank) floats; the
    tile form eight warps' 16 x 16 fp64 sums of X @ A and T, 16 KB and 16
    rank floats, rank rounded up to 16."""
    if form == "row":
        return 4 * (d_in + 9 * rank)
    return 8 * 8 * 16 * 16 + 4 * 16 * (-(-rank // 16) * 16)


def run(fn, y, x, a, b, scale, idx, layer, form):
    """One launch of `fn` (``paddle_lora_delta`` of a build of this
    source) on checked tensors, on the current stream of y's device,
    counting nothing: its cudaError."""
    n, d_out = y.shape
    _, num_layers, d_in, rank = a.shape
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(y.device).cuda_stream
    return fn(*(ctypes.c_void_p(t.data_ptr())
                for t in (y, x, a, b, scale, idx)),
              n, d_in, d_out, rank, layer, num_layers, y.stride(0),
              x.stride(0), idx.stride(0), FORMS.index(form),
              0 if y.dtype == torch.float32 else 1, ctypes.c_void_p(stream))


def lora_delta(y, x, a, b, scale, idx, layer):
    """Add each row's adapter delta to y ``[N, out]`` in place (see the
    module docstring); returns y."""
    if y.device.type == "cpu":
        return lora_delta_reference(y, x, a, b, scale, idx, layer)
    _check(y, x, a, b, scale, idx, layer)
    n, d_out = y.shape
    k, num_layers, d_in, rank = a.shape
    form = lora_form(idx)
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
    if smem_bytes(form, d_in, rank) > SMEM_LIMIT:
        raise ValueError(f"in {d_in} and rank {rank} take "
                         f"{smem_bytes(form, d_in, rank)} B of shared "
                         f"memory in the {form} form, past its 48 KB")
    if n == 0:
        return y
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows exceed the kernel's grid")
    require_hopper(y)
    with torch.cuda.device(y.device):
        err = run(_build.load("lora_delta").paddle_lora_delta, y, x, a, b,
                  scale, idx, layer, form)
    if err != 0:
        raise RuntimeError(f"lora_delta launch failed: cudaError {err}")
    launches["lora_delta"] += 1
    return y
