"""Fused softmax cross-entropy: the Hopper kernels, their plain PyTorch twins
and the autograd Function that joins them.

Counterpart of `paddle_tpu/kernels/cross_entropy.py` (`_fwd_kernel` /
`_fwd`, `_bwd_kernel` / `_bwd`, the `custom_vjp`
`fused_softmax_cross_entropy`, `is_eligible` and `masked_reduce`).

Contract (shared by kernels and twins): logits ``[R, V]`` float32,
bfloat16 or float16, integer labels ``[R]``. The forward gives the per-row loss and
logsumexp, both ``[R]`` float32: ``loss = lse - logits[r, label]``; a label
outside ``[0, V)`` (a negative ignore_index) picks nothing, so its loss is
``lse`` and the caller masks it. The backward gives
``dlogits = (softmax(logits) - onehot(label)) * g`` in the logits' dtype.

On CUDA tensors `cross_entropy_fwd` / `cross_entropy_bwd` launch the two
kernels of ``csrc/cross_entropy.cu`` or raise; on CPU tensors they run
`cross_entropy_fwd_reference` / `cross_entropy_bwd_reference`. The TPU
kernel pads the vocabulary to 2048 and rows to 128; the CUDA kernels pad
nothing and mask their own tails, so any V works.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import require_hopper
from ..ops import numerics
from ..framework.flags import get_flags
from . import _build
from ._dtype import FLOAT_DTYPES, dtype_code

__all__ = ["fused_softmax_cross_entropy", "FusedSoftmaxCrossEntropy",
           "cross_entropy_fwd", "cross_entropy_fwd_reference",
           "cross_entropy_bwd", "cross_entropy_bwd_reference",
           "is_eligible", "masked_reduce", "launches", "DTYPES",
           "MIN_VOCAB"]

DTYPES = FLOAT_DTYPES
# below this vocabulary the unfused path is used unless forced, as in the
# reference's routing rule
MIN_VOCAB = 8192

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"cross_entropy_fwd": 0, "cross_entropy_bwd": 0}

_FWD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def masked_reduce(nll, labels, ignore_index, reduction):
    """The ignore_index masking and reduction every fused entry point
    shares: rows whose raw label equals `ignore_index` count 0; "mean"
    divides by ``max(valid rows, 1)``."""
    valid = labels != ignore_index
    nll = torch.where(valid, nll, torch.zeros((), dtype=nll.dtype,
                                              device=nll.device))
    if reduction == "mean":
        return nll.sum() / torch.clamp(valid.sum().to(torch.float32), min=1.0)
    if reduction == "sum":
        return nll.sum()
    return nll


def is_eligible(logits, labels, force=False):
    """The reference's routing rule: 2-D logits and 1-D labels; unless
    `force`, also ``FLAGS_use_fused_cross_entropy`` and a vocabulary of at
    least `MIN_VOCAB`. The same on both devices."""
    if logits.ndim != 2 or labels.ndim != 1:
        return False
    if not force:
        if not get_flags("FLAGS_use_fused_cross_entropy")[
                "FLAGS_use_fused_cross_entropy"]:
            return False
        if logits.shape[1] < MIN_VOCAB:
            return False
    return True


def _check(logits, labels):
    if logits.ndim != 2 or labels.ndim != 1 \
            or labels.shape[0] != logits.shape[0]:
        raise ValueError(f"fused cross-entropy takes logits [R, V] and "
                         f"labels [R], got {tuple(logits.shape)} and "
                         f"{tuple(labels.shape)}")
    if logits.shape[0] == 0 or logits.shape[1] == 0:
        raise ValueError(f"empty logits {tuple(logits.shape)}")
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise TypeError(f"labels must be integers, got {labels.dtype}")


def cross_entropy_fwd_reference(logits, labels):
    """Plain PyTorch twin of the forward kernel: fp32 logsumexp, the
    label's logit picked directly. Returns ``(loss [R], lse [R])`` fp32."""
    _check(logits, labels)
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    v = x.shape[1]
    lab = labels.long()
    hit = (lab >= 0) & (lab < v)
    picked = x.gather(1, lab.clamp(0, v - 1)[:, None])[:, 0]
    picked = torch.where(hit, picked, torch.zeros((), device=x.device))
    return lse - picked, lse


def cross_entropy_bwd_reference(logits, labels, lse, g):
    """Plain PyTorch twin of the backward kernel:
    ``(exp(x - lse) - onehot(label)) * g`` in fp32, returned in the
    logits' dtype."""
    _check(logits, labels)
    x = logits.float()
    p = torch.exp(x - lse.float()[:, None])
    cols = torch.arange(x.shape[1], device=x.device)
    onehot = (cols[None, :] == labels.long()[:, None]).to(torch.float32)
    return ((p - onehot) * g.float()[:, None]).to(logits.dtype)


def _check_kernel_inputs(logits, labels):
    if logits.dtype not in DTYPES:
        raise TypeError(f"cross-entropy kernel takes {DTYPES}, got "
                        f"{logits.dtype}")
    if labels.device != logits.device:
        raise ValueError(f"labels on {labels.device}, logits on "
                         f"{logits.device}")
    if logits.stride(-1) != 1:
        raise ValueError("cross-entropy kernel needs contiguous rows "
                         "(logits.stride(-1) == 1)")
    if logits.shape[1] >= 2 ** 31 or logits.shape[0] >= 2 ** 31:
        raise ValueError(f"logits {tuple(logits.shape)} exceed the "
                         f"kernel's int32 sizes")
    require_hopper(logits)


def _lib_fn(name, argtypes):
    fn = getattr(_build.load("cross_entropy"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def cross_entropy_fwd(logits, labels):
    """Per-row ``(loss [R], lse [R])`` fp32 for logits ``[R, V]``."""
    if logits.device.type == "cpu":
        return cross_entropy_fwd_reference(logits, labels)
    _check(logits, labels)
    _check_kernel_inputs(logits, labels)
    r, v = logits.shape
    lab = labels.to(torch.int64).contiguous()
    loss = torch.empty(r, dtype=torch.float32, device=logits.device)
    lse = torch.empty(r, dtype=torch.float32, device=logits.device)
    fn = _lib_fn("paddle_cross_entropy_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(ctypes.c_void_p(logits.data_ptr()),
                 ctypes.c_void_p(lab.data_ptr()),
                 ctypes.c_void_p(loss.data_ptr()),
                 ctypes.c_void_p(lse.data_ptr()), r, v, logits.stride(0),
                 dtype_code(logits.dtype), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cross_entropy_fwd launch failed: cudaError {err}")
    launches["cross_entropy_fwd"] += 1
    numerics.check("cross_entropy_fwd", loss, lse)
    return loss, lse


def cross_entropy_bwd(logits, labels, lse, g):
    """``dlogits [R, V]`` in the logits' dtype, contiguous, from the
    forward's lse and the per-row loss gradient `g` ``[R]``."""
    if logits.device.type == "cpu":
        return cross_entropy_bwd_reference(logits, labels, lse, g)
    _check(logits, labels)
    _check_kernel_inputs(logits, labels)
    r, v = logits.shape
    for name, t in (("lse", lse), ("g", g)):
        if tuple(t.shape) != (r,) or t.device != logits.device:
            raise ValueError(f"{name} must be [{r}] on {logits.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    lab = labels.to(torch.int64).contiguous()
    # [R]-sized copies: an autograd gradient of a sum arrives expanded
    lse32 = lse.to(torch.float32).contiguous()
    g32 = g.to(torch.float32).contiguous()
    dlogits = torch.empty((r, v), dtype=logits.dtype, device=logits.device)
    fn = _lib_fn("paddle_cross_entropy_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(ctypes.c_void_p(logits.data_ptr()),
                 ctypes.c_void_p(lab.data_ptr()),
                 ctypes.c_void_p(lse32.data_ptr()),
                 ctypes.c_void_p(g32.data_ptr()),
                 ctypes.c_void_p(dlogits.data_ptr()), r, v, logits.stride(0),
                 dtype_code(logits.dtype), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cross_entropy_bwd launch failed: cudaError {err}")
    launches["cross_entropy_bwd"] += 1
    numerics.check("cross_entropy_bwd", dlogits)
    return dlogits


class FusedSoftmaxCrossEntropy(torch.autograd.Function):
    """Per-row loss with its gradient: `cross_entropy_fwd` forward,
    `cross_entropy_bwd` backward. Saves the logits, labels and the fp32
    lse; never a ``[R, V]`` log-softmax."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = cross_entropy_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return cross_entropy_bwd(logits, labels, lse, g), None


def fused_softmax_cross_entropy(logits, labels):
    """Per-row cross-entropy ``[R]`` fp32 for logits ``[R, V]`` and integer
    labels ``[R]``; a label outside ``[0, V)`` gives ``loss = lse`` (mask it
    in the caller, as `masked_reduce` does)."""
    return FusedSoftmaxCrossEntropy.apply(logits, labels)
