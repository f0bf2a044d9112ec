"""The multi-tensor Adam / AdamW update: the Hopper kernel and its plain
PyTorch twin.

Counterpart of the reference's optimizer update, which is no Pallas kernel:
`paddle_tpu/optimizer/optimizer.py` `_apply_optimize` jits the per-tensor
rule (`paddle_tpu/optimizer/optimizers.py` `Adam._adam_core`,
`AdamW._single_update`) over the whole parameter list, and XLA fuses it.
The rule, in fp32 as the reference computes it (`adam_rule`):

    m1   = b1 * m1 + (1 - b1) * g
    m2   = b2 * m2 + (1 - b2) * g * g
    base = master, or float(p) without one
    AdamW, decaying tensors: base = base * (1 - lr * coeff), cast to p's
        dtype and back where there is no master
    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    new  = base - lr_t * m1 / (sqrt(m2) + eps)

with lr and t (the step) fp32 scalars and b1, b2, (1 - b1), (1 - b2), eps
and coeff each rounded once from the Python double to fp32, as JAX's
weak-typed constants are. The new value goes to the master and, in p's
dtype, to p; the moments and masters are fp32.

`adam_update` updates lists of tensors in place. On CUDA tensors it
launches ``csrc/adam_update.cu`` once per `MAX_TENSORS` tensors (lr and t
are device scalars the kernel reads when it runs, so a CUDA graph replay
follows what the host set) or raises; on CPU tensors it runs
`adam_update_reference`, the rule tensor by tensor. Launches count under
``adam_update``.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from ..device import require_hopper
from . import _build
from ._dtype import FLOAT_DTYPES, dtype_code

__all__ = ["adam_update", "adam_update_reference", "adam_rule",
           "chunk_plan", "update_bytes", "launches", "DTYPES", "CHUNK",
           "MAX_TENSORS"]

DTYPES = FLOAT_DTYPES
# elements a CTA takes, and tensors a launch; the same as the source's
# kChunk and kMaxTensors (checked when the library loads)
CHUNK = 16384
MAX_TENSORS = 512

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"adam_update": 0}

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_float] * 6
             + [ctypes.c_int, ctypes.c_void_p])


def _f32(value):
    """`value` rounded once to the nearest fp32, as a Python float."""
    return struct.unpack("f", struct.pack("f", value))[0]


def adam_rule(p, g, m1, m2, master, lr, t, beta1, beta2, epsilon,
              coeff=0.0, decay=False):
    """One tensor's update, without side effects: ``(new p, m1, m2, new
    master or None)``. lr and t are fp32 scalars (numbers are rounded to
    fp32); decay applies AdamW's ``coeff`` to this tensor."""
    dev = m1.device
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    b1, b2 = _f32(beta1), _f32(beta2)
    gf = g.to(torch.float32)
    m1n = b1 * m1 + _f32(1 - beta1) * gf
    m2n = b2 * m2 + _f32(1 - beta2) * gf * gf
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    lr_t = lr * torch.sqrt(bc2) / bc1
    base = master if master is not None else p.to(torch.float32)
    if decay and coeff:
        base = base * (1 - lr * _f32(coeff))
        if master is None:
            base = base.to(p.dtype).to(torch.float32)
    new = base - lr_t * m1n / (torch.sqrt(m2n) + _f32(epsilon))
    return new.to(p.dtype), m1n, m2n, new if master is not None else None


@torch.no_grad()
def adam_update_reference(params, grads, m1s, m2s, masters, decays, lr, t,
                          beta1, beta2, epsilon, coeff):
    """Plain PyTorch twin: `adam_rule` tensor by tensor, written back in
    place."""
    for p, g, m1, m2, master, decay in zip(params, grads, m1s, m2s, masters,
                                           decays):
        new_p, m1n, m2n, new_master = adam_rule(
            p, g, m1, m2, master, lr, t, beta1, beta2, epsilon, coeff, decay)
        m1.copy_(m1n)
        m2.copy_(m2n)
        if master is not None:
            master.copy_(new_master)
        p.copy_(new_p)


def chunk_plan(numels, chunk=CHUNK):
    """The first chunk of each tensor and the total, ``[n + 1]``: tensor i
    owns CTAs ``[first[i], first[i + 1])`` of `chunk` elements each."""
    first = [0]
    for n in numels:
        first.append(first[-1] + -(-n // chunk))
    return first


def update_bytes(params, masters):
    """Bytes one update must move: each element's gradient (the param's
    dtype) and its fp32 m1, m2 and master read once, and m1, m2, the master
    and the param written once (the param read as the base where there is
    no master)."""
    total = 0
    for p, master in zip(params, masters):
        elem = p.element_size()
        base = 4 + 4 if master is not None else elem
        total += p.numel() * (elem + 8 + 8 + base + elem)
    return total


def _check(params, grads, m1s, m2s, masters, decays, lr, t):
    n = len(params)
    if not all(len(x) == n for x in (grads, m1s, m2s, masters, decays)):
        raise ValueError("adam_update takes lists of one length")
    dtype, device = params[0].dtype, params[0].device
    if dtype not in DTYPES:
        raise TypeError(f"adam_update kernel takes params in {DTYPES}, got "
                        f"{dtype}")
    for name, s in (("lr", lr), ("t", t)):
        if s.dtype != torch.float32 or s.numel() != 1 or s.device != device:
            raise ValueError(f"{name} must be one fp32 element on {device}, "
                             f"got {s.dtype} {tuple(s.shape)} on {s.device}")
    for p, g, m1, m2, master in zip(params, grads, m1s, m2s, masters):
        if p.dtype != dtype or g.dtype != dtype:
            raise TypeError(f"adam_update kernel takes params and grads of "
                            f"one dtype, got {p.dtype} and {g.dtype} with "
                            f"{dtype}")
        if g.shape != p.shape:
            raise ValueError(f"grad {tuple(g.shape)} for param "
                             f"{tuple(p.shape)}")
        for name, x in (("param", p), ("grad", g), ("moment1", m1),
                        ("moment2", m2), ("master", master)):
            if x is None:
                continue
            if x.device != device:
                raise ValueError(f"{name} on {x.device}, params on {device}")
            if not x.is_contiguous():
                raise ValueError(f"adam_update kernel needs a contiguous "
                                 f"{name}")
            if name in ("moment1", "moment2", "master") and (
                    x.dtype != torch.float32 or x.numel() != p.numel()):
                raise ValueError(f"{name} must be fp32 of {p.numel()} "
                                 f"elements, got {x.dtype} of {x.numel()}")
    require_hopper(params[0])


def _aligned(p, g, m1, m2, master):
    """Whether every pointer of a tensor allows the kernel's vector
    accesses (4 elements: 8 bytes of bf16 or f16, 16 of fp32)."""
    width = 4 * p.element_size()
    return (p.data_ptr() % width == 0 and g.data_ptr() % width == 0
            and all(x.data_ptr() % 16 == 0 for x in (m1, m2, master)
                    if x is not None))


_LIB = []


def _lib_fn():
    if not _LIB:
        lib = _build.load("adam_update")
        for name, want in (("paddle_adam_update_chunk", CHUNK),
                           ("paddle_adam_update_max_tensors", MAX_TENSORS)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            if fn() != want:
                raise RuntimeError(f"{name}() is {fn()}, the wrapper "
                                   f"expects {want}")
        fn = lib.paddle_adam_update
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _LIB.append(fn)
    return _LIB[0]


@torch.no_grad()
def adam_update(params, grads, m1s, m2s, masters, decays, lr, t, beta1,
                beta2, epsilon, coeff):
    """Update every ``params[i]`` (fp32, bf16 or f16, one dtype), its fp32
    moments ``m1s[i]``, ``m2s[i]`` and master ``masters[i]`` (None for
    none) in place from ``grads[i]`` (the params' dtype), with AdamW's
    decay ``coeff`` where ``decays[i]``; lr and t are one-element fp32
    tensors on the params' device."""
    if not params:
        return
    if params[0].device.type == "cpu":
        adam_update_reference(params, grads, m1s, m2s, masters, decays, lr,
                              t, beta1, beta2, epsilon, coeff)
        return
    _check(params, grads, m1s, m2s, masters, decays, lr, t)
    fn = _lib_fn()
    live = [i for i, p in enumerate(params) if p.numel()]
    consts = (_f32(beta1), _f32(beta2), _f32(1 - beta1), _f32(1 - beta2),
              _f32(epsilon), _f32(coeff))
    dtype = dtype_code(params[0].dtype)
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for at in range(0, len(live), MAX_TENSORS):
            idx = live[at:at + MAX_TENSORS]
            k = len(idx)
            ptrs = ctypes.c_void_p * k
            tensors = [(params[i], grads[i], m1s[i], m2s[i], masters[i])
                       for i in idx]
            arrays = [ptrs(*[None if x is None else x.data_ptr()
                             for x in col]) for col in zip(*tensors)]
            numels = [params[i].numel() for i in idx]
            first = chunk_plan(numels)
            flags = [(1 if decays[i] else 0)
                     | (2 if _aligned(*tensors[j]) else 0)
                     for j, i in enumerate(idx)]
            err = fn(k, *arrays, (ctypes.c_longlong * k)(*numels),
                     (ctypes.c_int * (k + 1))(*first),
                     (ctypes.c_ubyte * k)(*flags),
                     ctypes.c_void_p(lr.data_ptr()),
                     ctypes.c_void_p(t.data_ptr()), *consts, dtype,
                     ctypes.c_void_p(stream))
            if err != 0:
                raise RuntimeError(f"adam_update launch failed: cudaError "
                                   f"{err}")
            launches["adam_update"] += 1
