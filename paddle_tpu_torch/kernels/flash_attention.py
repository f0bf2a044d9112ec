"""Flash attention, forward and backward: the Hopper kernels, their plain
PyTorch twins and the autograd Function that joins them.

Counterpart of `paddle_tpu/kernels/flash_attention.py` (`_fwd_kernel` /
`_flash_fwd`, `_dq_kernel` + `_dkv_kernel` / `_flash_bwd`, and the
`custom_vjp` `flash_attention_bnhd`). Layouts are the JAX package's: q, k,
v ``[B, N, H, D]``; lse ``[B*H, N]`` float32.

- `flash_attention_fwd` returns ``(out, lse)``. On CUDA tensors it launches
  ``csrc/flash_attention_fwd.cu`` (or raises on what that kernel does not
  take); on CPU tensors it runs `flash_attention_reference`. bf16 and f16
  inputs go to the tensor-core kernel of their type (wgmma products, TMA
  loads), which needs 16-byte aligned bases and strides
  (`_tma_compatible`); fp32 inputs go to the fp32 FMA kernel, which keeps
  every product in fp32.
- `flash_attention_bwd` returns ``(dq, dk, dv)`` from the forward's out and
  lse: Delta = rowsum(O * dO) (`flash_attention_delta`, a plain torch
  reduction on both devices, as the JAX `_flash_bwd` computes it outside
  Pallas), then `flash_attention_bwd_dq` and `flash_attention_bwd_dkv`. On
  CUDA tensors those launch the two kernels of
  ``csrc/flash_attention_bwd.cu``; on CPU tensors they run their twins
  `flash_attention_bwd_dq_reference` / `flash_attention_bwd_dkv_reference`.
  As in the forward, bf16 and f16 inputs go to the tensor-core kernels
  (wgmma, TMA; q, k, v and dO must pass `_tma_compatible`) and fp32 inputs
  to the fp32 FMA kernels; the criteria against the fp32 twins are
  `flash_bwd_bf16_tol` / `FLASH_BWD_BF16_FRO_RTOL` and `flash_bwd_f16_tol`
  / `FLASH_BWD_F16_FRO_RTOL`.
- `flash_attention_fwd_op` is the forward as the `torch.library` op
  ``paddle_tpu_torch::flash_attention_fwd`` (the kernel on CUDA tensors,
  the twin on CPU tensors, a fake that gives the outputs' layout), which
  `torch.export` records as one node: a program saved by `jit.save`
  replays the kernel.
- `FlashAttention` / `flash_attention_bnhd` is the differentiable entry:
  the same Function on both devices, so a CPU test sees the graph the card
  sees; its forward calls the op.

Unlike the TPU kernels, no minimum length or multiple-of-128 rule applies:
the CUDA kernels mask their own ragged edges, so every prefill bucket (8 to
1024 tokens) runs them. The causal mask is top-left aligned, as on the TPU,
so causal attention requires ``n == m``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..device import require_hopper
from ..ops import numerics
from . import _build
from ._dtype import FLOAT_DTYPES, dtype_code

__all__ = ["flash_attention_fwd", "flash_attention_fwd_op",
           "flash_attention_reference",
           "flash_fwd_bf16_tol", "rel_fro",
           "FLASH_FWD_BF16_ATOL_PER_V", "FLASH_FWD_BF16_RTOL",
           "FLASH_FWD_BF16_FRO_RTOL", "flash_bwd_bf16_tol",
           "FLASH_BWD_BF16_ATOL_FACTOR", "FLASH_BWD_BF16_RTOL",
           "FLASH_BWD_BF16_FRO_RTOL", "flash_fwd_f16_tol",
           "FLASH_FWD_F16_RTOL", "FLASH_FWD_F16_FRO_RTOL",
           "flash_bwd_f16_tol", "FLASH_BWD_F16_RTOL",
           "FLASH_BWD_F16_FRO_RTOL", "F16_U", "F16_TINY",
           "flash_fwd_tol", "flash_bwd_tol", "flash_fro_rtol",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_reference",
           "flash_attention_delta", "FlashAttention", "flash_attention_bnhd",
           "launches", "HEAD_DIMS", "DTYPES"]

HEAD_DIMS = (64, 128)
DTYPES = FLOAT_DTYPES
_NEG_INF = -1e30

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}

_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 9
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
# The bf16 forward against its fp32 twin: the kernel rounds P = exp(S - m)
# to bf16 and multiplies it on the tensor cores (O += P V) where the twin
# keeps P in fp32. Each P entry moves by at most 2^-9 of itself and the
# p_j / l sum to 1, so O moves by at most 2^-9 max|v|; then one bf16
# rounding of the output (one bf16 step, at most 2^-7 of the value: rtol
# 8e-3). atol is twice that bound, 2^-8 max|v| of the case. A loose atol
# could hide a systematic error, so the relative Frobenius error is held as
# well: on random data the two roundings give about 2e-3 (each about 2^-9 /
# sqrt(3) rms); 4e-3. fp32 inputs run a kernel that rounds nothing to bf16
# and keep the tight fp32 tolerance of the other kernels.
FLASH_FWD_BF16_ATOL_PER_V = 2.0 ** -8
FLASH_FWD_BF16_RTOL = 8e-3
FLASH_FWD_BF16_FRO_RTOL = 4e-3
# The bf16 backward against its fp32 twin: the kernels round two operands
# to bf16 for the tensor cores where the twin keeps them in fp32, P (the A
# operand of dV += P^T dO) and dS (of dQ += dS K and dK += dS^T Q); S, dP
# and every sum stay fp32 on both sides, up to summation order. Each
# rounded element moves by at most 2^-9 of itself, so element by element
#   |dV - dV'| <= 2^-9 P^T |dO|,   |dQ - dQ'| <= 2^-9 scale |dS| |K|,
#   |dK - dK'| <= 2^-9 scale |dS|^T |Q|.
# atol is twice the largest of these bounds over the case's elements
# (FLASH_BWD_BF16_ATOL_FACTOR = 2 * 2^-9 times it, from the twin's P and
# dS); then one bf16 rounding of the output, at most 2^-8 of the value,
# held by rtol 8e-3 as in the forward. So the kernels' arithmetic uses at
# most half of each term. A loose atol could hide a systematic error, so
# the relative Frobenius error of each of dQ, dK and dV is held as well:
# one bf16 rounding is at most 2^-7 / sqrt(12) ~ 2.3e-3 rms of the value
# (~1.6e-3 averaged over mantissas), and the kernel against its twin sees
# three (the operand's, and the output's on each side), about 2.8e-3 in
# quadrature on random data. The limit is 5e-3, under twice that, and
# ten times below what a 3-mantissa-bit rounding of P and dS gives. fp32
# inputs run the fp32 FMA kernels, which round nothing to bf16, and keep
# the tight fp32 tolerance.
FLASH_BWD_BF16_ATOL_FACTOR = 2 * 2.0 ** -9
FLASH_BWD_BF16_RTOL = 8e-3
FLASH_BWD_BF16_FRO_RTOL = 5e-3
# The f16 kernels, by the same reasoning with f16's unit roundoff u = 2^-11
# (F16_U) in place of bf16's 2^-9, and one addition: f16 has 5 exponent
# bits, so a value below 2^-14 rounds to a subnormal, whose step is 2^-24:
# an absolute error of at most F16_TINY = 2^-25, where bf16 (fp32's range)
# keeps the relative one. So a rounded P or dS moves by at most
# u |x| + 2^-25 = u (|x| + 2^-14).
#   forward: O moves by at most sum_j (u p_j + 2^-25) |v_j| / l
#            <= (u + M 2^-25) max|v| (l >= 1, M keys); atol is twice that;
#            one f16 rounding of the output, 2^-10 of the value: rtol
#            2e-3; relative Frobenius error 1e-3 (bf16's 4e-3 scaled by
#            its u over f16's, 4).
#   backward: the bf16 bounds with |P| + 2^-14 and |dS| + 2^-14 s in place
#            of |P| and |dS|, s the kernels' dS factor at most (a power
#            of two, max(1, max|dS| / 2^14), see fit_f16 in
#            csrc/flash_attention_bwd.cu: dS is multiplied by 1 / s before
#            its rounding, so its subnormal step is 2^-24 s); atol twice
#            that (FACTOR 2 u); rtol 2e-3; relative Frobenius error 1.25e-3
#            (bf16's 5e-3 over 4).
F16_U = 2.0 ** -11
F16_TINY = 2.0 ** -25
FLASH_FWD_F16_RTOL = 2e-3
FLASH_FWD_F16_FRO_RTOL = 1e-3
FLASH_BWD_F16_RTOL = 2e-3
FLASH_BWD_F16_FRO_RTOL = 1.25e-3
# TMA's limits on a tensor map: a 16-byte aligned base, byte strides that
# are multiples of 16 and below 2**40
_TMA_ALIGN = 16
_TMA_MAX_STRIDE = 1 << 40
# the tensor-core kernels' error codes beyond cudaError_t
_ERR_NO_ENCODER = 100000
_ERR_ENCODE = 200000


def _check(q, k, v, causal):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention takes [B, N, H, D] q, k, v")
    b, n, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d) or v.shape != k.shape:
        raise ValueError(f"mismatched shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if causal and k.shape[1] != n:
        raise ValueError("causal flash attention is top-left aligned and "
                         f"needs n == m, got n={n}, m={k.shape[1]}")
    if n == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")


def _check_kernel_inputs(*tensors):
    """What the CUDA kernels take: fp32, bf16 or f16 (all alike), head_dim in
    HEAD_DIMS, one Hopper device, a contiguous last dimension, and at most
    65535 (batch, head) pairs (the grid's y limit)."""
    q = tensors[0]
    b, _, h, d = q.shape
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"flash kernel takes {DTYPES} (all alike), got "
                        f"{[t.dtype for t in tensors]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash kernel inputs must be on one device")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash kernel needs a contiguous head dimension")
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h} exceeds the grid limit")
    require_hopper(q)


def flash_attention_reference(q, k, v, causal, scale=None):
    """Plain PyTorch twin of the kernel: fp32 scores, top-left causal mask,
    fp32 softmax and logsumexp; out in q's dtype."""
    _check(q, k, v, causal)
    b, n, h, d = q.shape
    m = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qt = q.transpose(1, 2).float() * scale          # [B, H, N, D]
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2).float()
    s = qt @ kt.transpose(-1, -2)                   # [B, H, N, M]
    if causal:
        keep = torch.ones(n, m, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                # [B, H, N]
    p = torch.exp(s - lse[..., None])
    out = (p @ vt).transpose(1, 2).to(q.dtype)      # [B, N, H, D]
    return out.contiguous(), lse.reshape(b * h, n)


def flash_fwd_bf16_tol(v):
    """(atol, rtol) of the bf16 forward against `flash_attention_reference`
    for the value tensor `v` of the case (see FLASH_FWD_BF16_ATOL_PER_V);
    the relative Frobenius error is held to FLASH_FWD_BF16_FRO_RTOL
    besides (`rel_fro`)."""
    return (FLASH_FWD_BF16_ATOL_PER_V * float(v.float().abs().max()),
            FLASH_FWD_BF16_RTOL)


def flash_fwd_f16_tol(v):
    """(atol, rtol) of the f16 forward against `flash_attention_reference`
    for the value tensor `v` ``[B, M, H, D]`` of the case (see F16_U): atol
    twice ``(u + M 2^-25) max|v|``; the relative Frobenius error is held to
    FLASH_FWD_F16_FRO_RTOL besides (`rel_fro`)."""
    m = v.shape[1]
    return (2 * (F16_U + m * F16_TINY) * float(v.float().abs().max()),
            FLASH_FWD_F16_RTOL)


def flash_fwd_tol(v):
    """(atol, rtol) of the forward against its fp32 twin for inputs of
    v's type: `flash_fwd_bf16_tol`, `flash_fwd_f16_tol`, or None for fp32
    (the caller's own fp32 tolerance: that kernel rounds nothing)."""
    if v.dtype == torch.bfloat16:
        return flash_fwd_bf16_tol(v)
    if v.dtype == torch.float16:
        return flash_fwd_f16_tol(v)
    return None


def flash_fro_rtol(dtype, backward=False):
    """The relative Frobenius limit of a 2-byte type's flash kernels
    against their fp32 twins (None for fp32)."""
    if dtype == torch.bfloat16:
        return FLASH_BWD_BF16_FRO_RTOL if backward else FLASH_FWD_BF16_FRO_RTOL
    if dtype == torch.float16:
        return FLASH_BWD_F16_FRO_RTOL if backward else FLASH_FWD_F16_FRO_RTOL
    return None


def flash_bwd_bf16_tol(q, k, v, do, lse, delta, causal, scale):
    """``{"dq": (atol, rtol), "dk": ..., "dv": ...}`` of the bf16 backward
    against its fp32 twins for one case (the twins' arguments): atol is
    FLASH_BWD_BF16_ATOL_FACTOR times the largest rounding bound of each
    output, from the twin's P and dS (see FLASH_BWD_BF16_ATOL_FACTOR); the
    relative Frobenius error of each is held to FLASH_BWD_BF16_FRO_RTOL
    besides (`rel_fro`)."""
    qt, kt, gt, p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    ds = ds.abs()
    bounds = {"dq": (ds @ kt.abs()) * scale,            # qt carries scale
              "dk": ds.transpose(-1, -2) @ qt.abs(),
              "dv": p.transpose(-1, -2) @ gt.abs()}
    return {name: (FLASH_BWD_BF16_ATOL_FACTOR * float(bound.max()),
                   FLASH_BWD_BF16_RTOL)
            for name, bound in bounds.items()}


def flash_bwd_f16_tol(q, k, v, do, lse, delta, causal, scale):
    """``{"dq": (atol, rtol), "dk": ..., "dv": ...}`` of the f16 backward
    against its fp32 twins for one case: `flash_bwd_bf16_tol`'s bounds with
    u = F16_U and each rounded P or dS entry x counted as |x| + 2^-14 (its
    subnormal floor; dS's times the kernels' dS factor s, see F16_U)."""
    qt, kt, gt, p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    ds = ds.abs()
    s = max(1.0, float(ds.max()) / 2.0 ** 14)
    p = p + 2.0 ** -14
    ds = ds + 2.0 ** -14 * s
    bounds = {"dq": (ds @ kt.abs()) * scale,            # qt carries scale
              "dk": ds.transpose(-1, -2) @ qt.abs(),
              "dv": p.transpose(-1, -2) @ gt.abs()}
    return {name: (2 * F16_U * float(bound.max()), FLASH_BWD_F16_RTOL)
            for name, bound in bounds.items()}


def flash_bwd_tol(q, k, v, do, lse, delta, causal, scale):
    """The backward's per-output tolerances for q's 2-byte type
    (`flash_bwd_bf16_tol` or `flash_bwd_f16_tol`)."""
    fn = flash_bwd_f16_tol if q.dtype == torch.float16 else flash_bwd_bf16_tol
    return fn(q, k, v, do, lse, delta, causal, scale)


def rel_fro(got, want):
    """||got - want||_F / ||want||_F, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def _tma_compatible(t, name):
    """None when TMA can read `t` as a ``[B, N, H, D]`` operand of the bf16
    or f16 kernels; else why not, naming the tensor `name`. TMA needs a
    16-byte aligned base and byte strides that are multiples of 16 (so a
    multiple of 8 2-byte elements), each below 2**40; a size-1 dimension's
    stride is never used. The fused-qkv views of the model qualify: a row
    stride of 3 * hidden elements, k and v offset by hidden and 2 * hidden."""
    if t.stride(-1) != 1:
        return f"{name}: the head dimension must be contiguous (stride " \
               f"{t.stride(-1)})"
    if t.data_ptr() % _TMA_ALIGN:
        return (f"{name}: base address {t.data_ptr():#x} (storage offset "
                f"{t.storage_offset()} elements) is not {_TMA_ALIGN}-byte "
                "aligned")
    for dim, label in enumerate(("batch", "sequence", "head")):
        stride = t.stride(dim) * t.element_size()
        if t.shape[dim] == 1:
            continue
        if stride <= 0 or stride % _TMA_ALIGN or stride >= _TMA_MAX_STRIDE:
            return (f"{name}: {label} stride {t.stride(dim)} elements "
                    f"({stride} B) is not a positive multiple of "
                    f"{_TMA_ALIGN} bytes below 2**40")
    return None


def _require_tma(what, **tensors):
    """Raise ValueError naming the first of `tensors` (name=tensor) that
    TMA cannot read (`_tma_compatible`); `what` names the caller."""
    for name, t in tensors.items():
        why = _tma_compatible(t, name)
        if why is not None:
            raise ValueError(f"{what}: the {t.dtype} kernel loads through "
                             f"TMA and cannot read {why}")


def _tma_strides(t):
    """`t`'s (batch, seq, head) element strides for its tensor map, with
    the stride of a size-1 dimension (never used, but checked by the CUDA
    driver) replaced by the extent of the dimensions inside it."""
    strides = []
    inner = t.shape[-1]
    for dim in (2, 1, 0):
        stride = t.stride(dim)
        if t.shape[dim] == 1:
            stride = -(-inner // 8) * 8
        strides.append(stride)
        inner = max(inner, stride * t.shape[dim])
    return strides[::-1]


def _raise_for(err, name):
    """Raise for a kernel entry's nonzero return: a cudaError_t, or one of
    the tensor-core entries' tensor-map codes."""
    if err >= _ERR_ENCODE:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {err - _ERR_ENCODE}")
    if err == _ERR_NO_ENCODER:
        raise RuntimeError(f"{name}: the CUDA driver offers no "
                           "cuTensorMapEncodeTiled")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _launch_fwd(q, k, v, causal, scale):
    """The forward kernel on CUDA tensors (checked, launched, counted):
    ``(out, lse)``. Raises on what the kernel does not take."""
    _check(q, k, v, causal)
    _check_kernel_inputs(q, k, v)
    b, n, h, d = q.shape
    m = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    code = dtype_code(q.dtype)
    if code:
        _require_tma("flash forward", q=q, k=k, v=v)
        strides = [s for t in (q, k, v) for s in _tma_strides(t)]
    else:
        strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    lib = _build.load("flash_attention_fwd")
    fn = lib.paddle_flash_attention_fwd
    fn.argtypes = _FWD_ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
                 ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                 ctypes.c_void_p(lse.data_ptr()), b, n, m, h, d, *strides,
                 float(scale), int(bool(causal)), code,
                 ctypes.c_void_p(stream))
    _raise_for(err, "flash_attention_fwd")
    launches["flash_attention_fwd"] += 1
    return out, lse


def flash_attention_fwd(q, k, v, causal, scale=None):
    """FlashAttention forward over ``[B, N, H, D]`` q, k, v. Returns
    ``(out [B, N, H, D] in q's dtype, lse [B*H, N] float32)``."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    out, lse = _launch_fwd(q, k, v, causal, scale)
    numerics.check("flash_attention_fwd", out, lse)
    return out, lse


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cuda")
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool,
                           scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention_fwd` as the op
    ``paddle_tpu_torch::flash_attention_fwd``, the form `torch.export`
    records, so a saved program replays the kernel: on CUDA tensors the
    kernel (counted), on CPU tensors the twin. Under `ops.numerics`'
    dispatch mode the op's outputs are checked under its name by the mode
    itself, which sees the op."""
    return _launch_fwd(q, k, v, causal, scale)


@flash_attention_fwd_op.register_kernel("cpu")
def _flash_attention_fwd_cpu(q, k, v, causal, scale):
    return flash_attention_reference(q, k, v, causal, scale)


@flash_attention_fwd_op.register_fake
def _flash_attention_fwd_fake(q, k, v, causal, scale):
    """The outputs' layout: out ``[B, N, H, D]`` contiguous in q's dtype,
    lse ``[B*H, N]`` contiguous float32."""
    _check(q, k, v, causal)
    b, n, h, d = q.shape
    return (q.new_empty((b, n, h, d)),
            q.new_empty((b * h, n), dtype=torch.float32))


_BWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def flash_attention_delta(out, do):
    """Delta = rowsum(O * dO) in fp32, as ``[B*H, N]``: a plain torch
    reduction on both devices, as the JAX `_flash_bwd` computes it outside
    Pallas."""
    b, n, h, _ = out.shape
    delta = (out.float() * do.float()).sum(-1)          # [B, N, H]
    return delta.transpose(1, 2).reshape(b * h, n).contiguous()


def _bwd_probs(q, k, v, do, lse, delta, causal, scale):
    """The backward's recomputation, in fp32 ``[B, H, ...]``: scale * q,
    k, dO, P = exp(S - lse) and dS / scale = P * (dO V^T - Delta)."""
    _check(q, k, v, causal)
    b, n, h, _ = q.shape
    m = k.shape[1]
    qt = q.transpose(1, 2).float() * scale          # [B, H, N, D]
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2).float()
    gt = do.transpose(1, 2).float()
    s = qt @ kt.transpose(-1, -2)                   # [B, H, N, M]
    if causal:
        keep = torch.ones(n, m, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.exp(s - lse.reshape(b, h, n, 1))      # masked: exactly 0
    ds = p * (gt @ vt.transpose(-1, -2) - delta.reshape(b, h, n, 1))
    return qt, kt, gt, p, ds


def _bnhd(t, dtype):
    return t.transpose(1, 2).to(dtype).contiguous()


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                     scale):
    """Plain twin of the dQ kernel: ``dQ = dS K``, contiguous, q's dtype."""
    _, kt, _, _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    return _bnhd((ds @ kt) * scale, q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                      scale):
    """Plain twin of the dK/dV kernel: ``dK = dS^T Q``, ``dV = P^T dO``."""
    qt, _, gt, p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    return (_bnhd(ds.transpose(-1, -2) @ qt, q.dtype),   # qt carries scale
            _bnhd(p.transpose(-1, -2) @ gt, q.dtype))


def _launch_bwd(name, q, k, v, do, lse, delta, outs, causal, scale):
    _check(q, k, v, causal)
    _check_kernel_inputs(q, k, v, do)
    b, n, h, d = q.shape
    if tuple(do.shape) != (b, n, h, d):
        raise ValueError(f"do {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    for label, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b * h, n) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{label} must be contiguous float32 [B*H, N] "
                             f"= [{b * h}, {n}] on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    code = dtype_code(q.dtype)
    if code:
        _require_tma(f"flash_attention_bwd_{name}", q=q, k=k, v=v, do=do)
        strides = [s for t in (q, k, v, do) for s in _tma_strides(t)]
    else:
        strides = [t.stride(i) for t in (q, k, v, do) for i in range(3)]
    fn = getattr(_build.load("flash_attention_bwd"),
                 f"paddle_flash_attention_bwd_{name}")
    fn.argtypes = (_BWD_ARGTYPES[:6] + [ctypes.c_void_p] * len(outs)
                   + _BWD_ARGTYPES[6:])
    fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(ctypes.c_void_p(t.data_ptr())
                   for t in (q, k, v, do, lse, delta, *outs)),
                 b, n, k.shape[1], h, d, strides, float(scale),
                 int(bool(causal)), code, ctypes.c_void_p(stream))
    _raise_for(err, f"flash_attention_bwd_{name}")
    launches[f"flash_attention_bwd_{name}"] += 1
    numerics.check(f"flash_attention_bwd_{name}", *outs)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale):
    """dQ ``[B, N, H, D]`` from the forward's lse and Delta (see
    `flash_attention_delta`); the dQ kernel on the card."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("dq", q, k, v, do, lse, delta, (dq,), causal, scale)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    """``(dK, dV)`` ``[B, M, H, D]``; the dK/dV kernel on the card."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, scale)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("dkv", q, k, v, do, lse, delta, (dk, dv), causal, scale)
    return dk, dv


def flash_attention_bwd_reference(q, k, v, out, lse, do, causal, scale=None):
    """Plain PyTorch twin of the whole backward: the dQ and dK/dV twins,
    each recomputing P in fp32 from lse, as the two kernels do."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = flash_attention_delta(out, do)
    return (flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                             causal, scale),
            *flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               causal, scale))


def flash_attention_bwd(q, k, v, out, lse, do, causal, scale=None):
    """FlashAttention-2 backward over ``[B, N, H, D]`` q, k, v, the
    forward's out and lse ``[B*H, N]``, and the output gradient `do`.
    Returns ``(dq, dk, dv)`` in q's dtype, contiguous: Delta, then the dQ
    kernel and the dK/dV kernel on the card, their twins on the CPU."""
    if out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} must match q "
                         f"{tuple(q.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = flash_attention_delta(out, do)
    return (flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale),
            *flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale))


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward through the op
    `flash_attention_fwd_op` (so `torch.export` keeps the kernel in a saved
    program), `flash_attention_bwd` backward (kernels on the card, plain
    twins on the CPU). Saves q, k, v, out and the fp32 lse; nothing of
    size N x M."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1])
        out, lse = flash_attention_fwd_op(q, k, v, bool(causal),
                                          float(scale))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1 or (do.dtype != torch.float32
                                  and _tma_compatible(do, "do") is not None):
            # the kernels read dO's rows in place whatever their strides,
            # but not an expanded gradient (the gradient of a sum has
            # stride 0 everywhere), nor in bf16 or f16 one that TMA cannot
            # read (a misaligned one may be contiguous already): this Function
            # owns the gradient, so it copies those into fresh storage
            do = do.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_bnhd(q, k, v, causal=False, scale=None):
    """Flash attention over ``[batch, seq, heads, head_dim]`` tensors, with
    its gradient (the JAX package's `custom_vjp` entry of the same name)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, causal, scale)
