"""The sampler's processors: the Hopper kernel and its plain PyTorch twin.

Counterpart of the reference's `_stoch` filter
(`paddle_tpu/serving/sampling.py:141-166`): the CTRL repetition penalty,
the temperature, then the top-k and top-p thresholds from one descending
sort, applied together (top-p measured on the full distribution, not on
the top-k survivors). XLA compiles it in the reference: there is no Pallas
kernel for it.

`sampler_filter_reference`, the twin, is that sort-based filter in
PyTorch. On CUDA tensors `sampler_filter` launches
``csrc/sampler_filter.cu`` or raises: the same function without a sort or a
scan (radix select over a cluster of CTAs a row, the top-p mass in fixed
point), which writes only the rows that sample (temperature > 0) and
leaves the others as they were; on CPU tensors it runs the twin, which
computes every row. The two agree bit for bit on every written element
except where an exclusive mass of the sorted row lies within the kernel's
fixed-point margin of top_p: there the kernel's row is the twin's cut at
one of the thresholds `margin_cuts` allows.
Launches count under ``sampler_filter``.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import require_hopper
from . import _build

__all__ = ["sampler_filter", "sampler_filter_reference",
           "apply_repetition_penalty", "apply_temperature", "margin_cuts",
           "launches", "MAX_VOCAB", "MARGIN"]

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"sampler_filter": 0}

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p])

_NEG_INF = -1e30

# the kernel keeps a CTA's slice of a row (ceil(V / 8) elements, 8 bytes
# and a bit each) in shared memory
MAX_VOCAB = 8 * 24576


# Kernel and twin may choose different top-p thresholds only where an
# exclusive mass of the sorted row lies within MARGIN of top_p. The
# kernel's mass is each probability rounded to a multiple of 2^-32 (at most
# 2^-33 each, 5.9e-6 over 50304 terms) and expf's 2 ulp (relative 2.4e-7),
# normalised by an fp64 sum; the twin's is the float32 softmax and cumsum
# of the sorted row (rounded once each: relative ~1e-7 of the prefix)
MARGIN = 1e-5


def apply_repetition_penalty(logits, history, valid, penalty):
    """Divide positive / multiply negative logits of already-seen tokens by
    ``penalty`` (the CTRL rule). ``history`` ``[S, C]`` context ids,
    ``valid`` ``[S, C]`` bool, ``penalty`` ``[S]`` with 1.0 the no-op."""
    v = logits.shape[-1]
    ids = history.long().clamp(0, v - 1)
    seen = torch.zeros(logits.shape, dtype=torch.float32,
                       device=logits.device)
    seen.scatter_add_(1, ids, valid.to(torch.float32))
    pen = penalty[:, None].to(logits.dtype)
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen > 0, penalized, logits)


def apply_temperature(logits, temperature):
    """Scale by 1/T with a safe divisor (T=0 slots are decided by the
    greedy argmax, never by these values)."""
    t = torch.clamp(temperature, min=1e-6)[:, None].to(logits.dtype)
    return logits / t


def sampler_filter_reference(logits, temperature, top_k, top_p,
                             repetition_penalty, history, valid):
    """Plain PyTorch twin: the processors in order on ``[S, V]`` fp32
    logits, every row: repetition penalty, temperature, then top-k and
    top-p from ONE descending sort, both thresholds applied together."""
    lg = apply_repetition_penalty(logits, history, valid, repetition_penalty)
    lg = apply_temperature(lg, temperature)
    v = lg.shape[-1]
    desc = torch.sort(lg, dim=-1, descending=True).values
    kth = desc.gather(-1, (top_k.long() - 1).clamp(0, v - 1)[:, None])
    k_thresh = torch.where((top_k > 0)[:, None], kth,
                           torch.full_like(kth, _NEG_INF))
    # softmax over the sorted row IS the sorted distribution: the
    # exclusive-mass prefix maps straight back to a logit threshold
    p_desc = torch.softmax(desc, dim=-1)
    exclusive = torch.cumsum(p_desc, dim=-1) - p_desc
    keep_sorted = exclusive < top_p[:, None]
    n_keep = keep_sorted.sum(dim=-1).clamp(min=1)
    pth = desc.gather(-1, (n_keep - 1)[:, None])
    p_thresh = torch.where((top_p < 1.0)[:, None], pth,
                           torch.full_like(pth, _NEG_INF))
    thresh = torch.maximum(k_thresh, p_thresh)
    return lg.masked_fill(lg < thresh, _NEG_INF)


def margin_cuts(logits, temperature, top_k, top_p, repetition_penalty,
                history, valid):
    """Where the kernel may cut each row, given its top-p masses are off
    by at most `MARGIN`: ``(lg, cuts)``, the processed logits ``[S, V]``
    fp32 (penalty and temperature, as the twin computes them) and for
    each row a list of float32 values c such that the kernel's row is
    ``lg.masked_fill(lg < c, -1e30)`` for one of them. Each c is
    max(k_th, t) over the top-p thresholds t that masses in float64 off
    by at most MARGIN give: a distinct value t of the row whose exclusive
    mass (the mass above it) is below top_p + MARGIN while the next
    smaller distinct value's is at least top_p - MARGIN. The twin's cut
    is always among them; a row with more than one lies inside the
    margin. Greedy rows get none."""
    lg = apply_temperature(apply_repetition_penalty(
        logits, history, valid, repetition_penalty), temperature)
    v = lg.shape[-1]
    desc = torch.sort(lg, dim=-1, descending=True).values
    kth = desc.gather(-1, (top_k.long() - 1).clamp(0, v - 1)[:, None])[:, 0]
    p_desc = torch.softmax(desc.double(), dim=-1)
    exclusive = torch.cumsum(p_desc, dim=-1) - p_desc
    cuts = []
    for r in range(lg.shape[0]):
        if not temperature[r] > 0:
            cuts.append([])
            continue
        k_th = float(kth[r]) if top_k[r] > 0 else _NEG_INF
        if not top_p[r] < 1.0:
            cuts.append([k_th])
            continue
        p = float(top_p[r])
        # each distinct value's first sorted occurrence: its exclusive mass
        first = torch.ones(v, dtype=torch.bool)
        first[1:] = desc[r, 1:] != desc[r, :-1]
        vals, mass = desc[r][first], exclusive[r][first]
        below = torch.cat([mass[1:], mass.new_full((1,), float("inf"))])
        ok = (mass < p + MARGIN) & (below >= p - MARGIN)
        found = {max(k_th, float(t)) for t in vals[ok]}
        cuts.append(sorted(found, reverse=True))
    return lg, cuts


def sampler_filter(logits, temperature, top_k, top_p, repetition_penalty,
                   history, valid, out=None):
    """The filtered logits ``[S, V]`` fp32 of `logits` ``[S, V]`` fp32
    under each slot's temperature, top-k (int32), top-p and repetition
    penalty ``[S]`` and its context ``history`` (int32) and ``valid``
    (bool) ``[S, C]``, written into `out` (a fresh tensor when None) and
    returned. On the card only the rows with temperature > 0 are written;
    the others keep what `out` held (the keyed draw never reads them)."""
    if logits.device.type == "cpu":
        res = sampler_filter_reference(logits, temperature, top_k, top_p,
                                       repetition_penalty, history, valid)
        if out is None:
            return res
        return out.copy_(res)
    if logits.ndim != 2 or history.ndim != 2:
        raise ValueError(f"sampler filter takes logits [S, V] and history "
                         f"[S, C], got {tuple(logits.shape)} and "
                         f"{tuple(history.shape)}")
    s, v = logits.shape
    c = history.shape[1]
    if out is None:
        out = torch.empty_like(logits)
    want = {"logits": (logits, torch.float32, (s, v)),
            "temperature": (temperature, torch.float32, (s,)),
            "top_k": (top_k, torch.int32, (s,)),
            "top_p": (top_p, torch.float32, (s,)),
            "repetition_penalty": (repetition_penalty, torch.float32, (s,)),
            "history": (history, torch.int32, (s, c)),
            "valid": (valid, torch.bool, (s, c)),
            "out": (out, torch.float32, (s, v))}
    for name, (t, dtype, shape) in want.items():
        # history and valid may be row slices of a wider buffer
        rows_only = name in ("history", "valid")
        dense = (t.stride(-1) == 1 or c <= 1) if rows_only \
            else t.is_contiguous()
        if t.device != logits.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not dense:
            raise ValueError(f"sampler filter kernel needs {name} as a "
                             f"{'row-major' if rows_only else 'contiguous'} "
                             f"{dtype} {shape} on {logits.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if v > MAX_VOCAB:
        raise ValueError(f"vocabulary of {v} exceeds the kernel's "
                         f"{MAX_VOCAB}")
    require_hopper(logits)
    if s == 0:
        return out
    fn = _build.load("sampler_filter").paddle_sampler_filter
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(ctypes.c_void_p(logits.data_ptr()),
                 ctypes.c_void_p(temperature.data_ptr()),
                 ctypes.c_void_p(top_k.data_ptr()),
                 ctypes.c_void_p(top_p.data_ptr()),
                 ctypes.c_void_p(repetition_penalty.data_ptr()),
                 ctypes.c_void_p(history.data_ptr()), history.stride(0),
                 ctypes.c_void_p(valid.data_ptr()), valid.stride(0), c,
                 ctypes.c_void_p(out.data_ptr()), s, v,
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sampler_filter launch failed: cudaError {err}")
    launches["sampler_filter"] += 1
    return out
