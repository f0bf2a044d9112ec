"""Fused bias + residual + LayerNorm: the Hopper kernel, its plain PyTorch
twin and the autograd Function that joins them.

Counterpart of `paddle_tpu/kernels/fused_ln.py` (`_kernel` / `_run`, the
`custom_vjp` `fused_bias_residual_layer_norm`, `_reference` and
`is_eligible`). Contract (shared by kernel and twin): x and residual
``[R, d]`` of one dtype (float32, bfloat16 or float16), bias / scale /
shift ``[d]`` (float32, bfloat16 or float16); returns

    y = LayerNorm(x + bias + residual) * scale + shift

in x's dtype, with fp32 statistics whatever the input type (two-pass
variance: the mean first, then the mean of the centred squares).

On CUDA tensors `fused_ln_fwd` launches ``csrc/fused_ln.cu`` or raises; on
CPU tensors it runs `fused_ln_reference`. `fused_ln_fwd_op` is the same
function as the `torch.library` op ``paddle_tpu_torch::fused_ln_fwd`` (a
fake gives its output's layout), which `torch.export` records as one node,
so a program saved by `jit.save` replays the kernel. The backward
differentiates the plain formula on the saved inputs, as the reference's
`custom_vjp` does (`jax.vjp` over `_reference`): that is XLA code there,
not a TPU kernel, so it stays PyTorch ops on both devices. Launches count under ``fused_ln``.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import require_hopper
from ..ops import numerics
from ..framework.flags import get_flags
from . import _build
from ._dtype import FLOAT_DTYPES, dtype_code

__all__ = ["fused_bias_residual_layer_norm", "FusedBiasResidualLayerNorm",
           "fused_ln_fwd", "fused_ln_fwd_op", "fused_ln_reference",
           "is_eligible", "launches", "DTYPES"]

DTYPES = FLOAT_DTYPES

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"fused_ln": 0}

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _pick_block_r(d):
    """The reference's row-block rule (x, residual and out blocks in about
    6 MB of VMEM); None means the row is too wide for the fused route. The
    port keeps it as the eligibility rule only, so both packages route the
    same shapes."""
    budget = 6 * 1024 * 1024 // (3 * 4 * d)
    for br in (256, 128, 64, 32, 16, 8):
        if br <= budget:
            return br
    return None


def is_eligible(x, d):
    """``FLAGS_use_fused_layer_norm``, ``d % 128 == 0`` and a row narrow
    enough for the reference's row blocks; the same on both devices."""
    if not get_flags("FLAGS_use_fused_layer_norm")[
            "FLAGS_use_fused_layer_norm"]:
        return False
    return d % 128 == 0 and _pick_block_r(d) is not None


def _check(x, residual, bias, scale, shift):
    if x.ndim != 2 or tuple(residual.shape) != tuple(x.shape):
        raise ValueError(f"fused LayerNorm takes x and residual [R, d], got "
                         f"{tuple(x.shape)} and {tuple(residual.shape)}")
    d = x.shape[1]
    for name, t in (("bias", bias), ("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (d,):
            raise ValueError(f"{name} must be [{d}], got {tuple(t.shape)}")


def fused_ln_reference(x, residual, bias, scale, shift, eps=1e-5):
    """Plain PyTorch twin (a copy of the reference's `_reference`)."""
    _check(x, residual, bias, scale, shift)
    z = x.float() + bias.float() + residual.float()
    mean = z.mean(dim=-1, keepdim=True)
    c = z - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + eps) * scale.float() + shift.float()
    return y.to(x.dtype)


def _launch(x, residual, bias, scale, shift, eps):
    """The kernel on CUDA tensors (checked, launched, counted); raises on
    what it does not take."""
    _check(x, residual, bias, scale, shift)
    r, d = x.shape
    if x.dtype not in DTYPES or residual.dtype != x.dtype:
        raise TypeError(f"fused LayerNorm kernel takes x and residual of one "
                        f"dtype in {DTYPES}, got {x.dtype}, {residual.dtype}")
    affine = (bias, scale, shift)
    if any(t.dtype not in DTYPES for t in affine):
        raise TypeError(f"bias, scale and shift must be in {DTYPES}, got "
                        f"{[t.dtype for t in affine]}")
    if len({t.dtype for t in affine}) > 1:
        # one type for the three (bf16 or f16 -> fp32 is exact, and the
        # kernel reads each as fp32)
        affine = tuple(t.float() for t in affine)
    if d % 128 or d > 65536:
        raise ValueError(f"fused LayerNorm kernel takes d % 128 == 0 and "
                         f"d <= 65536, got {d}")
    if r >= 2 ** 31:
        raise ValueError(f"{r} rows exceed the kernel's grid")
    for name, t in (("x", x), ("residual", residual), ("bias", affine[0]),
                    ("scale", affine[1]), ("shift", affine[2])):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused LayerNorm kernel needs a contiguous "
                             f"{name}")
        if t.data_ptr() % 16:
            raise ValueError(f"fused LayerNorm kernel needs 16-byte aligned "
                             f"{name}")
    require_hopper(x)
    out = torch.empty_like(x)
    if r == 0:
        return out
    fn = _build.load("fused_ln").paddle_fused_ln
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(ctypes.c_void_p(t.data_ptr())
                   for t in (x, residual, *affine, out)),
                 r, d, float(eps), dtype_code(x.dtype),
                 dtype_code(affine[0].dtype),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused_ln launch failed: cudaError {err}")
    launches["fused_ln"] += 1
    return out


def fused_ln_fwd(x, residual, bias, scale, shift, eps=1e-5):
    """``LN(x + bias + residual) * scale + shift`` ``[R, d]`` in x's
    dtype."""
    if x.device.type == "cpu":
        return fused_ln_reference(x, residual, bias, scale, shift, eps)
    out = _launch(x, residual, bias, scale, shift, eps)
    numerics.check("fused_ln", out)
    return out


@torch.library.custom_op("paddle_tpu_torch::fused_ln_fwd", mutates_args=(),
                         device_types="cuda")
def fused_ln_fwd_op(x: torch.Tensor, residual: torch.Tensor,
                    bias: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, eps: float) -> torch.Tensor:
    """`fused_ln_fwd` as the op ``paddle_tpu_torch::fused_ln_fwd``, the
    form `torch.export` records, so a saved program replays the kernel:
    on CUDA tensors the kernel (counted), on CPU tensors the twin. Under
    `ops.numerics`' dispatch mode the mode itself checks the op's output
    under its name."""
    return _launch(x, residual, bias, scale, shift, eps)


@fused_ln_fwd_op.register_kernel("cpu")
def _fused_ln_fwd_cpu(x, residual, bias, scale, shift, eps):
    return fused_ln_reference(x, residual, bias, scale, shift, eps)


@fused_ln_fwd_op.register_fake
def _fused_ln_fwd_fake(x, residual, bias, scale, shift, eps):
    """The output's layout: ``[R, d]`` contiguous in x's dtype."""
    _check(x, residual, bias, scale, shift)
    return x.new_empty(x.shape)


class FusedBiasResidualLayerNorm(torch.autograd.Function):
    """`fused_ln_fwd` forward, through its op `fused_ln_fwd_op` (so
    `torch.export` keeps the kernel in a saved program); the backward
    differentiates `fused_ln_reference` on the saved inputs (the
    reference's VJP) and returns the gradients of x, residual, bias, scale
    and shift."""

    @staticmethod
    def forward(ctx, x, residual, bias, scale, shift, eps):
        ctx.save_for_backward(x, residual, bias, scale, shift)
        ctx.eps = eps
        return fused_ln_fwd_op(x, residual, bias, scale, shift, float(eps))

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = fused_ln_reference(*inputs, ctx.eps)
            grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None)


def fused_bias_residual_layer_norm(x, residual, bias, scale, shift,
                                   eps=1e-5):
    """y = LN(x + bias + residual) * scale + shift for x / residual
    ``[R, d]`` and bias / scale / shift ``[d]``; differentiable in all
    five."""
    return FusedBiasResidualLayerNorm.apply(x, residual, bias, scale, shift,
                                            eps)
