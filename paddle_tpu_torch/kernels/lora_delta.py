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

with A ``[K, L, in, r]``, B ``[K, L, r, out]`` (the model's dtype, float32,
bfloat16 or float16), scale ``[K]`` float32 and idx int32 (``[N]``, or one slot
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
    ``X @ A`` once (bf16 and f16 on the tensor cores, fp32 on the FMA
    units) and
    reads A and B once a tile.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import require_hopper
from ..ops import numerics
from . import _build
from ._dtype import FLOAT_DTYPES, dtype_code

__all__ = ["lora_delta", "lora_delta_reference", "lora_delta_exact",
           "lora_delta_tol", "lora_form", "smem_bytes", "run", "launches",
           "DTYPES", "FORMS"]

DTYPES = FLOAT_DTYPES

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
    only. A second yardstick beside the twin: the card's check prints how
    far the kernel and the twin each lie from it; both must lie within
    `lora_delta_tol` of each other."""
    _check(y, x, a, b, scale, idx, layer)
    sel = idx.long()
    t = torch.bmm(x.double()[:, None, :], a[sel, layer].double())
    t = t.float().to(y.dtype).double()
    u = torch.bmm(t, b[sel, layer].double())[:, 0].float().to(y.dtype)
    d = u * scale[sel].to(y.dtype)[:, None]
    return torch.where((sel != 0)[:, None], y + d, y)


def _gamma(n, unit):
    """gamma_n = n u / (1 - n u): the relative bound of a sum of n terms
    in round-to-nearest arithmetic of unit roundoff u, whatever the order
    of the additions (and with or without fused multiply-adds)."""
    return n * unit / (1.0 - n * unit)


# unit roundoffs: fp32, fp64, and what one rounding to T may add below the
# normal range (bf16 and fp32 share fp32's exponent range, 2^-149 half its
# subnormal step; f16's subnormal step is 2^-24)
_U32 = 2.0 ** -24
_U64 = 2.0 ** -53
_ETA = 2.0 ** -149
# T's unit roundoff u and its eta (see lora_delta_tol)
_ROUNDING = {torch.bfloat16: (2.0 ** -8, _ETA),
             torch.float16: (2.0 ** -11, 2.0 ** -25),
             torch.float32: (_U32, _ETA)}


def lora_delta_tol(y, x, a, b, scale, idx, layer):
    """Per-element bound on |kernel - twin| for these inputs (y before the
    delta), derived from the roundings both make; 0 on base rows.

    Model. One rounding to nearest of a value v is off by at most half a
    unit in the last place of the result, at most u |v| + eta with u =
    2^-8 for bf16 (8 significant bits), 2^-11 for f16 (11 significant
    bits), 2^-24 for fp32, and eta covering results below the normal range
    (half the subnormal step: 2^-25 for f16, whose normal range ends at
    2^-14; 2^-149 for bf16 and fp32). A sum of n terms in fp32 with
    rounding to nearest (any order, fused multiply-adds or not; fp64 sums
    are better still) is off its exact value by at most gamma_n sum|term|,
    gamma_n = n 2^-24 / (1 - n 2^-24). Both computations take the same
    steps in the model's dtype T, sums in fp32 or better:

      t = R_T(sum_i x_i A_i)          (in terms)
      w = R_T(sum_r t_r B_r)          (rank terms)
      d = R_T(w sigma),  sigma = R_T(scale) (exact, the same for both)
      y' = R_T(y + d)                  (y + d formed in fp32 first)

    Against the exact values t* = x A, w* = t* B, d* = w* sigma, each
    step's error of one computation is, element by element (fp64 sums of
    the magnitudes, their own error folded in by gamma at 2^-53):

      e1 = gamma_in |x| |A|           E_t = e1 + u (|t*| + e1)
      e2 = E_t |B| + gamma_rank (|t*| + E_t) |B|
                                       E_w = e2 + u (|w*| + e2)
      E_d = E_w |sigma| + u (|d*| + E_w |sigma|)
      E_y = E_d + (2^-24 + u (1 + 2^-24)) (|y + d*| + E_d)

    (the last: an fp32 rounding of y + d, then one to T). The kernel and
    the twin are each within E_y of y + d*, so they differ by at most 2
    E_y: one bf16 step of t (up to 2^-7 of a value just above a power of
    two; an f16 step, 2^-10) is inside 2 u |t*|, and an fp32 sum's error scales with sum|x| |A|,
    not with |t|, as it must. For fp32 T the R_T of t and w are exact in
    the twin and one fp32 rounding of an fp64 sum in the kernel's tile
    form: u = 2^-24 covers both. The bound is tight enough to see a wrong
    delta: a dropped rank column, or the scale off by 2^-5, leaves it
    (tests/test_torch_lora_delta.py)."""
    u, eta = _ROUNDING[y.dtype]
    sel = idx.long()
    d_in, rank = a.shape[2], a.shape[3]
    g_in = _gamma(d_in, _U32) + _gamma(d_in, _U64)
    g_r = _gamma(rank, _U32) + _gamma(rank, _U64)
    bound = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
    # one slot at a time: its rows share A and B (no per-row copies)
    for slot in sorted(set(sel.tolist()) - {0}):
        rows = torch.nonzero(sel == slot)[:, 0]
        xs = x[rows].double()
        a_s, b_s = a[slot, layer].double(), b[slot, layer].double()
        t = xs @ a_s                                          # [n, r]
        p1 = (xs.abs() @ a_s.abs()) * (1 + _gamma(d_in, _U64))
        e1 = g_in * p1
        e_t = e1 + u * (t.abs() + e1) + eta
        b_abs = b_s.abs()
        w = t @ b_s                                           # [n, out]
        mag_w = (t.abs() @ b_abs) * (1 + _gamma(rank, _U64))
        prop = e_t @ b_abs
        e2 = prop + g_r * (mag_w + prop)
        e_w = e2 + u * (w.abs() + e2) + eta
        sigma = abs(float(scale[slot].to(y.dtype)))
        d = w * float(scale[slot].to(y.dtype))
        e_d = e_w * sigma + u * (d.abs() + e_w * sigma) + eta
        z = y[rows].double() + d
        e_y = e_d + (_U32 + u * (1 + _U32)) * (z.abs() + e_d) + 2 * eta
        bound[rows] = (2 * e_y).float()
    return bound


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
              dtype_code(y.dtype), ctypes.c_void_p(stream))


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
    numerics.check("lora_delta", y)
    return y
