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

The numeric guard's two forms (``FLAGS_check_numerics``, `GUARDS`), each
with an int32 device `flag`: ``guard="probe"`` writes nothing and ORs 1
into the flag where a gradient or a new value (m1, m2, the master, p in
its dtype) is not finite; ``guard="apply"`` is the update where the flag
is 0 and nothing where it is not. Their launches count under
``adam_update_probe`` and ``adam_update_apply``. The twin's forms read the
flag on the device (`torch.where`), so neither syncs.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from ..device import require_hopper
from ..ops import numerics
from . import _build
from ._dtype import FLOAT_DTYPES, dtype_code

__all__ = ["adam_update", "adam_update_reference", "adam_rule",
           "chunk_plan", "plan_args", "load_planned", "update_bytes",
           "probe_bytes", "launches", "DTYPES", "CHUNK", "MAX_TENSORS",
           "ALIGNED", "GUARDS"]

DTYPES = FLOAT_DTYPES
# elements a CTA takes, and tensors a launch; the same as kChunk and
# kMaxTensors of csrc/multi_tensor.cuh, the streaming pass this kernel and
# kernels.finite_check's share (checked when each library loads)
CHUNK = 16384
MAX_TENSORS = 512
# a tensor's flags bit: its pointers allow the kernels' 4-element vector
# accesses (mt::kAligned); bit 0 is this kernel's AdamW decay
ALIGNED = 2

# the guard's forms and their codes in the C entry (0: the plain update)
GUARDS = {"probe": 1, "apply": 2}

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"adam_update": 0, "adam_update_probe": 0,
            "adam_update_apply": 0}

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_float] * 6
             + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p])


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
                          beta1, beta2, epsilon, coeff, guard=None,
                          flag=None):
    """Plain PyTorch twin: `adam_rule` tensor by tensor, written back in
    place; with `guard`, the probe (the flag ORed with 1 where a gradient
    or a new value is not finite) or the update where `flag` is 0."""
    for p, g, m1, m2, master, decay in zip(params, grads, m1s, m2s, masters,
                                           decays):
        new_p, m1n, m2n, new_master = adam_rule(
            p, g, m1, m2, master, lr, t, beta1, beta2, epsilon, coeff, decay)
        new = [(m1, m1n), (m2, m2n), (p, new_p)]
        if master is not None:
            new.append((master, new_master))
        if guard == "probe":
            bad = ~torch.isfinite(g).all()
            for _, value in new:
                bad |= ~torch.isfinite(value).all()
            flag.bitwise_or_(bad.to(flag.dtype))
            continue
        for old, value in new:
            old.copy_(value if guard is None
                      else torch.where(flag != 0, old, value))


def chunk_plan(numels, chunk=CHUNK):
    """The first chunk of each tensor and the total, ``[n + 1]``: tensor i
    owns CTAs ``[first[i], first[i + 1])`` of `chunk` elements each."""
    first = [0]
    for n in numels:
        first.append(first[-1] + -(-n // chunk))
    return first


def plan_args(numels, flags):
    """The plan arguments of a multi-tensor C entry for tensors of
    `numels` (none empty, at most `MAX_TENSORS`) with their `flags`
    bytes: ``(numel[n], first_chunk[n + 1], flags[n])`` as ctypes
    arrays."""
    k = len(numels)
    return ((ctypes.c_longlong * k)(*numels),
            (ctypes.c_int * (k + 1))(*chunk_plan(numels)),
            (ctypes.c_ubyte * k)(*flags))


def load_planned(name):
    """The library of source `name`, after checking that its
    ``paddle_<name>_chunk()`` and ``paddle_<name>_max_tensors()`` are
    `CHUNK` and `MAX_TENSORS`, the plan `plan_args` builds."""
    lib = _build.load(name)
    for query, want in ((f"paddle_{name}_chunk", CHUNK),
                        (f"paddle_{name}_max_tensors", MAX_TENSORS)):
        fn = getattr(lib, query)
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"{query}() is {fn()}, the wrapper expects "
                               f"{want}")
    return lib


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


def probe_bytes(params, masters):
    """Bytes the probe must read: each element's gradient (the param's
    dtype), its fp32 m1 and m2, and its master (fp32) or the param."""
    total = 0
    for p, master in zip(params, masters):
        elem = p.element_size()
        total += p.numel() * (elem + 8 + (4 if master is not None else elem))
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
        fn = load_planned("adam_update").paddle_adam_update
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _LIB.append(fn)
    return _LIB[0]


@torch.no_grad()
def adam_update(params, grads, m1s, m2s, masters, decays, lr, t, beta1,
                beta2, epsilon, coeff, guard=None, flag=None):
    """Update every ``params[i]`` (fp32, bf16 or f16, one dtype), its fp32
    moments ``m1s[i]``, ``m2s[i]`` and master ``masters[i]`` (None for
    none) in place from ``grads[i]`` (the params' dtype), with AdamW's
    decay ``coeff`` where ``decays[i]``; lr and t are one-element fp32
    tensors on the params' device. `guard` "probe" or "apply" takes the
    guard's forms over the int32 one-element device tensor `flag` (module
    docstring)."""
    if not params:
        return
    if guard is not None and (guard not in GUARDS or flag is None
                              or flag.dtype != torch.int32
                              or flag.numel() != 1
                              or flag.device != params[0].device):
        raise ValueError(f"guard must be one of {tuple(GUARDS)} with an "
                         f"int32 one-element flag on the params' device, "
                         f"got {guard!r} and {flag!r}")
    if params[0].device.type == "cpu":
        adam_update_reference(params, grads, m1s, m2s, masters, decays, lr,
                              t, beta1, beta2, epsilon, coeff, guard, flag)
        return
    _check(params, grads, m1s, m2s, masters, decays, lr, t)
    fn = _lib_fn()
    name = "adam_update" if guard is None else f"adam_update_{guard}"
    mode = 0 if guard is None else GUARDS[guard]
    flag_ptr = ctypes.c_void_p(None if flag is None else flag.data_ptr())
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
            flags = [(1 if decays[i] else 0)
                     | (ALIGNED if _aligned(*tensors[j]) else 0)
                     for j, i in enumerate(idx)]
            err = fn(k, *arrays,
                     *plan_args([params[i].numel() for i in idx], flags),
                     ctypes.c_void_p(lr.data_ptr()),
                     ctypes.c_void_p(t.data_ptr()), *consts, mode,
                     flag_ptr, dtype, ctypes.c_void_p(stream))
            if err != 0:
                raise RuntimeError(f"{name} launch failed: cudaError "
                                   f"{err}")
            launches[name] += 1
            if guard != "probe":
                numerics.check(name, *(params[i] for i in idx))
