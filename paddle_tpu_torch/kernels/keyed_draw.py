"""The sampler's keyed draw: the Hopper kernel and its plain PyTorch twin.

Counterpart of the reference's stochastic token draw,
``jax.random.categorical(fold_in(PRNGKey(seed), position), filtered)``
(`paddle_tpu/serving/sampling.py:168-171`, keys from
`paddle_tpu/framework/random.py:206-216`), which XLA compiles: there is no
Pallas kernel for it. With ``jax_threefry_partitionable`` (on in the
installed jax 0.9.0) the draw for one slot is, bit for bit:

  * the key: ``PRNGKey(seed)`` is ``(0, seed)``; ``fold_in(key, p)`` is
    ``threefry2x32(key, (0, p))``;
  * the bits of vocab index i: ``y0 ^ y1`` of ``threefry2x32(key, (0, i))``;
  * the uniform in ``[tiny, 1)``: ``max(tiny, bitcast((bits >> 9) |
    0x3F800000) - 1 + tiny)``;
  * the noise: ``-log(-log(u))``, with XLA's float32 ``log`` on the CPU (a
    Cephes polynomial whose multiply-adds LLVM fuses at fixed places;
    `xla_log` repeats it operation for operation);
  * the token: the first index of the largest ``noise + filtered``.

A slot with ``temperature <= 0`` takes the first index of the largest raw
logit instead (the greedy path).

``row_stride`` (0 for the engine) moves each row's counters: row s draws
index i at counter ``s * row_stride + i``. `GPTForCausalLM.generate`'s
sampled pick is ``jax.random.categorical(fold_in(PRNGKey(seed), step),
logits [B, V])``, one key over the batch, whose element (b, v) takes
counter ``b * V + v`` (partitionable threefry counts the flattened
index): it passes every row that key and ``row_stride=V``. The twin is written in int64 arithmetic
with 32-bit masks, on the CPU; its bits and its noise are equal to
`jax.random`'s (tests/test_torch_sampling_keyed.py).

On CUDA tensors `keyed_draw` launches ``csrc/keyed_draw.cu`` (a thread
block cluster a slot, each CTA a slice of the vocabulary) or raises; on
CPU tensors it runs `keyed_draw_reference`. The kernel
writes the token straight into the caller's buffers (the engine's output
and device feedback buffers). Launches count under ``keyed_draw``, or
``keyed_draw_rows`` with a row stride (`generate`'s draw).
"""
from __future__ import annotations

import ctypes

import torch

from ..device import require_hopper
from ..ops import numerics
from . import _build

__all__ = ["keyed_draw", "keyed_draw_reference", "threefry2x32",
           "slot_keys", "random_bits", "uniform", "xla_log", "gumbel",
           "launches"]

# kernel launches since import (or the last reset by the caller), by kernel
launches = {"keyed_draw": 0, "keyed_draw_rows": 0}

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _f32(value):
    if isinstance(value, str):
        value = float.fromhex(value)
    return torch.tensor(value, dtype=torch.float32)


# XLA's float32 log (Cephes): sqrt(1/2), the polynomial's coefficients and
# ln 2 split in two; every value is exact in float32
_SQRTHF = _f32("0x1.6a09e6p-1")
_P = [_f32(c) for c in ("0x1.204376p-4", "-0x1.d7a37p-4", "-0x1.fcba9ep-4",
                        "0x1.23d37ep-3", "0x1.999d58p-3", "-0x1.fffff8p-3",
                        "0x1.de4a34p-4", "-0x1.555ca0p-3", "0x1.555554p-2")]
_LN2_LO = _f32("-0x1.bd0106p-13")
_LN2_HI = _f32("0x1.63p-1")
_ONE, _HALF, _ZERO = _f32(1.0), _f32(0.5), _f32(0.0)
_INF = _f32(float("inf"))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values,
    broadcast together; returns ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _u32(t):
    return t.to(torch.int64) & _M32


def slot_keys(seeds, positions):
    """``fold_in(PRNGKey(seed), position)`` for ``[S]`` seeds (read as
    uint32) and positions: the key words ``(k0, k1)``, int64 ``[S]``."""
    seeds, positions = _u32(seeds), _u32(positions)
    zero = torch.zeros_like(seeds)
    return threefry2x32(zero, seeds, zero, positions)


def random_bits(k0, k1, vocab, row_stride=0):
    """The 32 random bits of each index of a ``[vocab]`` draw under each
    slot's key, row s at counters ``s * row_stride + i``: int64 ``[S,
    vocab]`` holding uint32 values."""
    index = torch.arange(vocab, dtype=torch.int64, device=k0.device)[None, :]
    rows = torch.arange(k0.shape[0], dtype=torch.int64, device=k0.device)
    counter = (index + rows[:, None] * int(row_stride)) & _M32
    y0, y1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(counter),
                          counter)
    return y0 ^ y1


def uniform(bits):
    """Bits to float32 in ``[tiny, 1)``, as `jax.random.uniform` does."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - _ONE
    return torch.clamp(f + _TINY, min=_TINY)


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once. The product is exact in float64
    and TwoSum gives the sum's error, which settles the one case where
    rounding the float64 sum to float32 rounds twice (a float32 midpoint)."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    d = s - r.double()
    toward = torch.nextafter(r, torch.where(d > 0, _INF, -_INF))
    mid = (d != 0) & (2 * d.abs() == (toward.double() - r.double()).abs())
    fix = mid & (err != 0) & ((err > 0) == (d > 0))
    return torch.where(fix, toward, r)


def xla_log(x):
    """float32 log as XLA's CPU backend computes it (the reference's noise):
    frexp, the Cephes polynomial on ``[sqrt(1/2) - 1, sqrt(2) - 1)`` with
    its multiply-adds fused where LLVM fuses them, and ln 2 added back in
    two parts. 0 and denormals give -inf, negatives and NaN give NaN."""
    x1 = torch.where(x <= _TINY, _f32(_TINY), x)
    b = x1.view(torch.int32)
    e = ((b >> 23) - 127).float() + _ONE
    mant = ((b & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    small = mant < _SQRTHF
    xm = (mant - _ONE) + torch.where(small, mant, _ZERO)
    e = e - torch.where(small, _ONE, _ZERO)
    z = xm * xm
    z3 = z * xm
    y1 = _fma(_fma(xm, _P[0], _P[1]), xm, _P[6])
    y2 = _fma(_fma(xm, _P[2], _P[3]), xm, _P[7])
    y3 = _fma(_fma(xm, _P[4], _P[5]), xm, _P[8])
    y = _fma(_fma(y1, z3, y2), z3, y3)
    y = _fma(y, z3, _LN2_LO * e)
    r = _fma(_LN2_HI, e, _fma(-_HALF, z, xm) + y)
    r = torch.where((x >= 0) & (x < _TINY), -_INF, r)
    r = torch.where(x == _INF, _INF, r)
    return torch.where((x < 0) | torch.isnan(x), _f32(float("nan")), r)


def gumbel(seeds, positions, vocab, row_stride=0):
    """Each slot's Gumbel noise ``[S, vocab]`` float32: the reference's
    ``jax.random.gumbel(fold_in(PRNGKey(seed), position), (vocab,))``
    (row_stride 0), or row s of a ``[S, vocab]`` draw under one key
    (row_stride vocab)."""
    k0, k1 = slot_keys(seeds, positions)
    return -xla_log(-xla_log(uniform(random_bits(k0, k1, vocab,
                                                 row_stride))))


def _check(raw, filtered, temperature, seeds, positions):
    if raw.ndim != 2 or tuple(filtered.shape) != tuple(raw.shape):
        raise ValueError(f"keyed draw takes raw and filtered logits [S, V], "
                         f"got {tuple(raw.shape)} and "
                         f"{tuple(filtered.shape)}")
    s = raw.shape[0]
    for name, t in (("temperature", temperature), ("seeds", seeds),
                    ("positions", positions)):
        if tuple(t.shape) != (s,):
            raise ValueError(f"{name} must be [{s}], got {tuple(t.shape)}")


def keyed_draw_reference(raw, filtered, temperature, seeds, positions,
                         row_stride=0):
    """Plain PyTorch twin: each slot's token, int32 ``[S]``: the first
    argmax of ``gumbel + filtered`` where ``temperature > 0``, else of the
    raw logits."""
    _check(raw, filtered, temperature, seeds, positions)
    noise = gumbel(seeds, positions, raw.shape[1], row_stride)
    sampled = torch.argmax(noise + filtered.float(), dim=-1)
    greedy = torch.argmax(raw.float(), dim=-1)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)


def keyed_draw(raw, filtered, temperature, seeds, positions, out=None,
               feedback=None, debug=None, row_stride=0):
    """Each slot's next token (int32 ``[S]``) from raw and filtered fp32
    logits ``[S, V]``, temperatures, seeds (int32 holding uint32 bits) and
    positions ``[S]``; written into `out` (a fresh tensor when None) and,
    when given, into `feedback` too. `debug`, a pair of ``[S, V]`` int32
    and float32 tensors, receives every index's random bits and noise (the
    card's check against the twin; the kernel then draws them for greedy
    slots too). `row_stride`: row s draws at counters ``s * row_stride +
    i`` (module docstring). Returns `out`."""
    row_stride = int(row_stride)
    if raw.device.type == "cpu":
        nxt = keyed_draw_reference(raw, filtered, temperature, seeds,
                                   positions, row_stride)
        if debug is not None:
            k0, k1 = slot_keys(seeds, positions)
            bits = random_bits(k0, k1, raw.shape[1], row_stride)
            debug[0].copy_(bits.to(torch.int32))
            debug[1].copy_(-xla_log(-xla_log(uniform(bits))))
        if out is None:
            out = nxt
        else:
            out.copy_(nxt)
        if feedback is not None:
            feedback.copy_(nxt)
        return out
    _check(raw, filtered, temperature, seeds, positions)
    s, v = raw.shape
    if out is None:
        out = torch.empty(s, dtype=torch.int32, device=raw.device)
    want = {"raw": (raw, torch.float32, (s, v)),
            "filtered": (filtered, torch.float32, (s, v)),
            "temperature": (temperature, torch.float32, (s,)),
            "seeds": (seeds, torch.int32, (s,)),
            "positions": (positions, torch.int32, (s,)),
            "out": (out, torch.int32, (s,))}
    if feedback is not None:
        want["feedback"] = (feedback, torch.int32, (s,))
    if debug is not None:
        want["debug bits"] = (debug[0], torch.int32, (s, v))
        want["debug noise"] = (debug[1], torch.float32, (s, v))
    for name, (t, dtype, shape) in want.items():
        if t.device != raw.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"keyed draw kernel needs {name} as a "
                             f"contiguous {dtype} {shape} on {raw.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if v >= 2 ** 31:
        raise ValueError(f"vocabulary of {v} exceeds the kernel's indices")
    if row_stride < 0 or (s - 1) * row_stride + v > 2 ** 32 - 1:
        raise ValueError(f"row_stride {row_stride} over {s} rows of {v} "
                         f"takes counters past 32 bits")
    require_hopper(raw)
    if s == 0:
        return out
    fn = _build.load("keyed_draw").paddle_keyed_draw
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        err = fn(ptr(raw), ptr(filtered), ptr(temperature), ptr(seeds),
                 ptr(positions), ptr(out), ptr(feedback),
                 ptr(None if debug is None else debug[0]),
                 ptr(None if debug is None else debug[1]), s, v,
                 row_stride, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"keyed_draw launch failed: cudaError {err}")
    # no `numerics.check`: the outputs are token ids, not floats
    launches["keyed_draw_rows" if row_stride else "keyed_draw"] += 1
    return out
