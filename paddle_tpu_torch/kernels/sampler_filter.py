"""The sampler's processors: the Hopper kernel and its plain PyTorch twin.

Counterpart of the reference's `_stoch` filter
(`paddle_tpu/serving/sampling.py:141-166`): the CTRL repetition penalty,
the temperature, then the top-k and top-p thresholds from one descending
sort, applied together (top-p measured on the full distribution, not on
the top-k survivors). XLA compiles it in the reference: there is no Pallas
kernel for it.

`sampler_filter_reference`, the twin, is that sort-based filter in
PyTorch. On CUDA tensors `sampler_filter` launches
``csrc/sampler_filter.cu`` or raises: the same function without a full
sort or a scan (a cluster of CTAs a row; a row with top-k ranks only the
candidates at or above a bound on its k-th largest value, other rows take
a radix select; top-p masses in fixed point), which writes only the rows
that sample (temperature > 0) and leaves the others as they were; on CPU
tensors it runs the twin, which computes every row. `filter_routes` is
the kernel's choice of route for each row, by its own rule, in plain
PyTorch. The two agree bit for bit on every written element
except where an exclusive mass of the sorted row lies within the kernel's
fixed-point margin of top_p: there the kernel's row is the twin's cut at
one of the thresholds `margin_cuts` allows.
Launches count under ``sampler_filter``.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import require_hopper
from ..ops import numerics
from . import _build

__all__ = ["sampler_filter", "sampler_filter_reference",
           "apply_repetition_penalty", "apply_temperature", "margin_cuts",
           "filter_routes", "run", "launches", "MAX_VOCAB", "MARGIN",
           "ROUTES"]

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"sampler_filter": 0}

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p])
# paddle_sampler_filter_routes: the same and the routes buffer before the
# stream
_ROUTES_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_void_p]

# the source's grid (kThreads, kMaxCtas) and its candidates' cap (kMaxCand)
THREADS, MAX_CTAS = 1024, 8
MAX_CANDIDATES = THREADS
# what the kernel did with a row, by the code it reports
ROUTES = ("greedy", "uncut", "candidates", "overflow", "radix")

_NEG_INF = -1e30

# the kernel keeps a CTA's slice of a row (ceil(V / 8) elements, 8 bytes
# and a bit each) in shared memory beside its radix histograms
MAX_VOCAB = 8 * 24576


# Kernel and twin may choose different top-p thresholds only where an
# exclusive mass of the sorted row lies within MARGIN of top_p. The
# kernel's mass is each probability rounded to a multiple of 2^-32 (at most
# 2^-33 each, 5.9e-6 over 50304 terms) and exp's ulps (two expf's of 2
# ulp each, relative 4.8e-7, in the radix route; fp64 in the candidates'),
# over a normaliser summed in float32 over a warp's elements (relative
# ~1e-6) and in fp64 beyond; the twin's is the float32 softmax and cumsum
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


def plan(vocab):
    """The kernel's CTAs a row: one for every THREADS indices, at most
    MAX_CTAS (a cluster)."""
    return min(MAX_CTAS, -(-vocab // THREADS))


def candidate_bound(lg, k):
    """The kernel's lower bound w on the k-th largest value of the row
    `lg` ``[V]`` (1 <= k <= the row's warps): the least, over the CTAs, of
    each CTA's ceil(k / P)-th largest warp maximum, where thread j of a
    CTA takes indices j, j + THREADS, ... of its slice and a warp 32
    consecutive threads. Each CTA has that many warps whose maximum is
    >= w, and warps share no element, so at least k elements are >= w."""
    v = lg.shape[0]
    ctas = plan(v)
    chunk = -(-v // ctas)
    width = -(-chunk // THREADS) * THREADS
    quota = -(-k // ctas)
    bound = float("inf")
    for r in range(ctas):
        part = lg[min(v, r * chunk):min(v, (r + 1) * chunk)]
        pad = part.new_full((width,), float("-inf"))
        pad[:part.shape[0]] = part
        warp_max = pad.view(-1, THREADS // 32, 32).amax(dim=(0, 2))
        bound = min(bound, float(warp_max.sort(descending=True)
                                 .values[quota - 1]))
    return bound


def filter_routes(logits, temperature, top_k, top_p, repetition_penalty,
                  history, valid):
    """The route the kernel takes for each row, as codes into ROUTES
    (int32 ``[S]``): greedy (temperature <= 0: not written), uncut (no
    top-k and top-p >= 1), candidates (0 < min(k, V) <= the row's warps
    and at most MAX_CANDIDATES values >= `candidate_bound`), overflow
    (more: the radix select), radix (no top-k with top-p < 1, or k above
    the warps)."""
    lg = apply_temperature(apply_repetition_penalty(
        logits, history, valid, repetition_penalty), temperature)
    s, v = lg.shape
    warps = plan(v) * THREADS // 32
    routes = torch.zeros(s, dtype=torch.int32)
    for r in range(s):
        k, p = min(int(top_k[r]), v), float(top_p[r])
        if not temperature[r] > 0:
            code = "greedy"
        elif k <= 0:
            code = "radix" if p < 1.0 else "uncut"
        elif k > warps:
            code = "radix"
        else:
            taken = int((lg[r] >= candidate_bound(lg[r], k)).sum())
            code = "candidates" if taken <= MAX_CANDIDATES else "overflow"
        routes[r] = ROUTES.index(code)
    return routes


def sampler_filter(logits, temperature, top_k, top_p, repetition_penalty,
                   history, valid, out=None, routes=None):
    """The filtered logits ``[S, V]`` fp32 of `logits` ``[S, V]`` fp32
    under each slot's temperature, top-k (int32), top-p and repetition
    penalty ``[S]`` and its context ``history`` (int32) and ``valid``
    (bool) ``[S, C]``, written into `out` (a fresh tensor when None) and
    returned. On the card only the rows with temperature > 0 are written;
    the others keep what `out` held (the keyed draw never reads them).
    `routes`, an int32 ``[S]`` tensor on the logits' device, receives each
    row's route (codes into ROUTES; on the CPU `filter_routes`')."""
    if logits.device.type == "cpu":
        res = sampler_filter_reference(logits, temperature, top_k, top_p,
                                       repetition_penalty, history, valid)
        if routes is not None:
            routes.copy_(filter_routes(logits, temperature, top_k, top_p,
                                       repetition_penalty, history, valid))
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
    if routes is not None and (routes.device != logits.device
                               or routes.dtype != torch.int32
                               or tuple(routes.shape) != (s,)
                               or not routes.is_contiguous()):
        raise ValueError(f"sampler filter kernel needs routes as a "
                         f"contiguous int32 ({s},) on {logits.device}")
    if v > MAX_VOCAB:
        raise ValueError(f"vocabulary of {v} exceeds the kernel's "
                         f"{MAX_VOCAB}")
    require_hopper(logits)
    if s == 0:
        return out
    err = run(_build.load("sampler_filter"), logits, temperature, top_k,
              top_p, repetition_penalty, history, valid, out, routes)
    if err != 0:
        raise RuntimeError(f"sampler_filter launch failed: cudaError {err}")
    # no `numerics.check`: greedy rows of `out` are left unwritten, and
    # the sampled ones are what the draw reads, checked by nothing in the
    # reference either (its sampler runs inside a jitted program)
    launches["sampler_filter"] += 1
    return out


def run(lib, logits, temperature, top_k, top_p, repetition_penalty,
        history, valid, out, routes=None):
    """One launch of the filter in the loaded library `lib` (this source
    or another of the same C interface) on checked CUDA tensors, counting
    nothing: its cudaError. `routes` needs the library's
    ``paddle_sampler_filter_routes``."""
    name = "paddle_sampler_filter" + ("" if routes is None else "_routes")
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES if routes is None else _ROUTES_ARGTYPES
    fn.restype = ctypes.c_int
    tail = () if routes is None else (ctypes.c_void_p(routes.data_ptr()),)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        return fn(ctypes.c_void_p(logits.data_ptr()),
                  ctypes.c_void_p(temperature.data_ptr()),
                  ctypes.c_void_p(top_k.data_ptr()),
                  ctypes.c_void_p(top_p.data_ptr()),
                  ctypes.c_void_p(repetition_penalty.data_ptr()),
                  ctypes.c_void_p(history.data_ptr()), history.stride(0),
                  ctypes.c_void_p(valid.data_ptr()), valid.stride(0),
                  history.shape[1], ctypes.c_void_p(out.data_ptr()),
                  logits.shape[0], logits.shape[1], *tail,
                  ctypes.c_void_p(stream))
