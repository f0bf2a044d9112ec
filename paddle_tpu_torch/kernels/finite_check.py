"""The numeric guard's multi-tensor kernels: the finite check (with an
optional unscale) and the guarded copy, each beside its plain PyTorch twin.

No Pallas counterpart: under ``FLAGS_check_numerics`` the reference folds
an all-finite predicate and ``where(finite, new, old)`` into its jitted
update (`paddle_tpu/optimizer/optimizer.py:131-197`), and its `GradScaler`
computes found-inf and divides the gradients by the scale
(`paddle_tpu/amp/grad_scaler.py:92-113`); XLA fuses both.

- `multi_tensor_finite(tensors, flag, scale=None)`: ORs 1 into `flag` (an
  int32 one-element device tensor) where any element of `tensors` is a
  NaN or an inf; with `scale` (an fp32 one-element tensor) it also
  multiplies every tensor in place by it, rounded to the tensor's dtype,
  after the check: the `GradScaler`'s found-inf and unscale in one pass.
- `multi_tensor_copy_if(dsts, srcs, flag)`: ``dst.copy_(src)`` for each
  pair unless `flag` is set: the guarded optimizers' write of the new
  state they computed out of place.

On CUDA tensors each launches ``csrc/finite_check.cu`` once per dtype per
`MAX_TENSORS` tensors (the flag and the scale are read on the device, so
a CUDA graph replay follows them) or raises; CPU tensors take the twins,
which compute the same on the device with no host read. Launches count
under ``multi_tensor_finite``, ``multi_tensor_finite_unscale`` and
``multi_tensor_copy_if``.

The kernels take fp32, bf16, f16 and float64 tensors (type code 4,
`_dtype.wide_code`), in any layout whose elements are dense in memory:
contiguous, or a permutation of a contiguous layout such as the gradient
of a parameter made from a transposed view. The work is elementwise, so
such a tensor is passed by the start of its elements; a pair of the copy
must then have one shape and one stride. Another layout (a strided slice,
an expanded tensor) raises ValueError, as does a pair laid out apart.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import require_hopper
from ..ops import numerics
from ._dtype import FLOAT_DTYPES, wide_code
from .adam_update import ALIGNED, MAX_TENSORS, load_planned, plan_args

__all__ = ["multi_tensor_finite", "multi_tensor_finite_reference",
           "multi_tensor_copy_if", "multi_tensor_copy_if_reference",
           "launches", "DTYPES"]

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"multi_tensor_finite": 0, "multi_tensor_finite_unscale": 0,
            "multi_tensor_copy_if": 0}

# the dtypes the kernels instantiate
DTYPES = FLOAT_DTYPES + (torch.float64,)

_LIB = []


def _lib():
    if not _LIB:
        lib = load_planned("finite_check")
        for fn in (lib.paddle_multi_tensor_finite,
                   lib.paddle_multi_tensor_copy_if):
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                           + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def _check_scalar(name, s, dtype, device):
    if s.dtype != dtype or s.numel() != 1 or s.device != device:
        raise ValueError(f"{name} must be one {dtype} element on {device}, "
                         f"got {s.dtype} {tuple(s.shape)} on {s.device}")


def _by_dtype(tensors):
    """``{dtype: [index]}`` of the non-empty tensors, in first-seen order;
    TypeError for a dtype without an instantiation."""
    groups = {}
    for i, t in enumerate(tensors):
        if t.dtype not in DTYPES:
            raise TypeError(f"the finite-check kernels take {DTYPES}, got "
                            f"{t.dtype}")
        if t.numel():
            groups.setdefault(t.dtype, []).append(i)
    return groups


def _dense(t):
    """Whether `t`'s elements fill ``numel()`` consecutive places in memory
    from its data pointer (a permutation of a contiguous layout)."""
    want = 1
    for stride, size in sorted((s, n) for s, n in zip(t.stride(), t.shape)
                               if n != 1):
        if stride != want:
            return False
        want *= size
    return True


def _check_tensors(name, tensors, device):
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: a tensor on {t.device}, the flag on "
                             f"{device}")
        if t.numel() and not _dense(t):
            raise ValueError(
                f"{name} kernel needs tensors whose elements are dense in "
                f"memory (contiguous, or a permutation of it such as a "
                f"transpose), got shape {tuple(t.shape)} with strides "
                f"{t.stride()}")


def _flags(tensors, idx, *ptr_lists):
    """`ALIGNED` for each tensor of `idx` whose pointers (one from each of
    `ptr_lists`) all sit on a multiple of 4 elements, else 0."""
    width = 4 * tensors[idx[0]].element_size()
    return [ALIGNED if all(ptrs[i] % width == 0 for ptrs in ptr_lists)
            else 0 for i in idx]


# -- the finite check ---------------------------------------------------------

@torch.no_grad()
def multi_tensor_finite_reference(tensors, flag, scale=None):
    """Plain PyTorch twin: the flag ORed with 1 where an element is not
    finite (the largest magnitude of each tensor, as `GradScaler` took
    it), then each tensor times `scale` in its dtype."""
    by_dtype = {}
    for t in tensors:
        if t.numel():
            by_dtype.setdefault(t.dtype, []).append(t)
    if not by_dtype:
        return
    finite = None
    for dtype, ts in by_dtype.items():
        # float64 keeps its range; the others' maxima are exact in fp32
        maxima = torch._foreach_norm(ts, float("inf"), dtype=torch.float64
                                     if dtype == torch.float64
                                     else torch.float32)
        ok = torch.isfinite(torch.stack(maxima)).all()
        finite = ok if finite is None else finite & ok
    flag.bitwise_or_((~finite).to(flag.dtype))
    if scale is not None:
        for dtype, ts in by_dtype.items():
            torch._foreach_mul_(ts, scale.to(dtype))


@torch.no_grad()
def multi_tensor_finite(tensors, flag, scale=None):
    """OR 1 into `flag` where an element of `tensors` (fp32, bf16, f16 or
    float64, any mix) is not finite; with `scale`, multiply each tensor in
    place by it after the check (module docstring)."""
    if not tensors:
        return
    device = flag.device
    _check_scalar("flag", flag, torch.int32, device)
    if scale is not None:
        _check_scalar("scale", scale, torch.float32, device)
    if device.type == "cpu":
        multi_tensor_finite_reference(tensors, flag, scale)
        return
    _check_tensors("multi_tensor_finite", tensors, device)
    groups = _by_dtype(tensors)
    require_hopper(flag)
    fn = _lib().paddle_multi_tensor_finite
    name = "multi_tensor_finite" if scale is None \
        else "multi_tensor_finite_unscale"
    scale_ptr = ctypes.c_void_p(None if scale is None else scale.data_ptr())
    ptrs = [t.data_ptr() for t in tensors]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for dtype, members in groups.items():
            for at in range(0, len(members), MAX_TENSORS):
                idx = members[at:at + MAX_TENSORS]
                err = fn(len(idx), (ctypes.c_void_p * len(idx))(
                             *[ptrs[i] for i in idx]),
                         *plan_args([tensors[i].numel() for i in idx],
                                    _flags(tensors, idx, ptrs)),
                         ctypes.c_void_p(flag.data_ptr()), scale_ptr,
                         wide_code(dtype), ctypes.c_void_p(stream))
                if err != 0:
                    raise RuntimeError(f"{name} launch failed: cudaError "
                                       f"{err}")
                launches[name] += 1
                if scale is not None:
                    numerics.check(name, *(tensors[i] for i in idx))


# -- the guarded copy ---------------------------------------------------------

@torch.no_grad()
def multi_tensor_copy_if_reference(dsts, srcs, flag):
    """Plain PyTorch twin: each dst takes its src where `flag` is 0 and
    keeps its value elsewhere."""
    keep = flag != 0
    for d, s in zip(dsts, srcs):
        d.copy_(torch.where(keep, d, s))


@torch.no_grad()
def multi_tensor_copy_if(dsts, srcs, flag):
    """``dsts[i].copy_(srcs[i])`` for every pair (same dtype and number of
    elements each; on CUDA, both contiguous or of one shape and stride)
    unless the int32 one-element tensor `flag` is set."""
    if len(dsts) != len(srcs):
        raise ValueError("multi_tensor_copy_if takes lists of one length")
    if not dsts:
        return
    device = flag.device
    _check_scalar("flag", flag, torch.int32, device)
    for d, s in zip(dsts, srcs):
        if d.dtype != s.dtype or d.numel() != s.numel():
            raise ValueError(f"copy of {s.dtype} {tuple(s.shape)} into "
                             f"{d.dtype} {tuple(d.shape)}")
    if device.type == "cpu":
        multi_tensor_copy_if_reference(dsts, srcs, flag)
        return
    _check_tensors("multi_tensor_copy_if", list(dsts) + list(srcs), device)
    for d, s in zip(dsts, srcs):
        if not (d.is_contiguous() and s.is_contiguous()) and (
                d.shape != s.shape or d.stride() != s.stride()):
            raise ValueError(f"multi_tensor_copy_if kernel copies pairs laid "
                             f"out alike, got strides {s.stride()} into "
                             f"{d.stride()}")
    groups = _by_dtype(dsts)
    require_hopper(flag)
    fn = _lib().paddle_multi_tensor_copy_if
    dptrs = [t.data_ptr() for t in dsts]
    sptrs = [t.data_ptr() for t in srcs]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for dtype, members in groups.items():
            for at in range(0, len(members), MAX_TENSORS):
                idx = members[at:at + MAX_TENSORS]
                k = len(idx)
                err = fn(k, (ctypes.c_void_p * k)(*[dptrs[i] for i in idx]),
                         (ctypes.c_void_p * k)(*[sptrs[i] for i in idx]),
                         *plan_args([dsts[i].numel() for i in idx],
                                    _flags(dsts, idx, dptrs, sptrs)),
                         ctypes.c_void_p(flag.data_ptr()),
                         wide_code(dtype), ctypes.c_void_p(stream))
                if err != 0:
                    raise RuntimeError(f"multi_tensor_copy_if launch "
                                       f"failed: cudaError {err}")
                launches["multi_tensor_copy_if"] += 1
                numerics.check("multi_tensor_copy_if",
                               *(dsts[i] for i in idx))
