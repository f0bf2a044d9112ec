"""Per-slot sampler head of the serving engine.

Counterpart of `paddle_tpu/serving/sampling.py`. Masking order follows the
de-facto contract (HF logits processors): repetition penalty ->
temperature -> top-k -> top-p, then a Gumbel-max draw over the surviving
logits. ``top_k=0`` and ``top_p>=1`` are exact no-ops, and a slot with
``temperature=0`` returns ``argmax`` of the RAW logits — the greedy path
is exact.

Top-k and top-p thresholds come from one descending sort of the
post-temperature logits and are applied together, as in the JAX
`sample_tokens` (top-p is measured on the full distribution, not on the
top-k survivors).

The draw: each stochastic slot gets its own `torch.Generator` seeded from
``(seed, position)``, where ``position`` is the count of known context
tokens at sampling time. Replays (preemption re-prefill) restore the same
positions, so a given (seed, prompt, sampler config) reproduces its token
stream byte-identically. The bits are PyTorch's (Philox on the card), not
JAX's threefry: streams replay themselves, they do not match the JAX
package's.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

__all__ = ["validate_sampler", "default_seed", "apply_repetition_penalty",
           "apply_temperature", "apply_top_k", "apply_top_p", "filter_logits",
           "sample_tokens"]

_NEG_INF = -1e30


def default_seed(request_id):
    """Process-stable default seed for a request: crc32 of the request id."""
    return zlib.crc32(str(request_id).encode("utf-8")) & 0xFFFFFFFF


def validate_sampler(temperature, top_k, top_p, repetition_penalty):
    """Raise ValueError (the engine surfaces it as a `sampler_mismatch`
    refusal) for parameter values outside the sampler's contract."""
    t = float(temperature)
    if not (t >= 0.0) or t != t or t == float("inf"):
        raise ValueError(f"temperature must be finite and >= 0, got {temperature}")
    if int(top_k) < 0:
        raise ValueError(f"top_k must be >= 0 (0 disables), got {top_k}")
    p = float(top_p)
    if not (0.0 < p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    r = float(repetition_penalty)
    if not (r > 0.0) or r == float("inf"):
        raise ValueError(
            f"repetition_penalty must be finite and > 0, got {repetition_penalty}")


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


def apply_top_k(logits, top_k):
    """Keep the k highest logits per slot (ties at the k-th value survive);
    ``top_k`` ``[S]`` int, 0 disables."""
    v = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values
    kth = desc.gather(-1, (top_k.long() - 1).clamp(0, v - 1)[:, None])
    thresh = torch.where((top_k > 0)[:, None], kth,
                         torch.full_like(kth, _NEG_INF))
    return logits.masked_fill(logits < thresh, _NEG_INF)


def apply_top_p(logits, top_p):
    """Nucleus filter: keep the smallest prefix of the descending
    distribution with cumulative mass >= p (exclusive-mass test, so the
    top-1 token always survives); ``top_p >= 1`` is an exact no-op."""
    probs = torch.softmax(logits, dim=-1)
    desc = torch.sort(probs, dim=-1, descending=True).values
    exclusive = torch.cumsum(desc, dim=-1) - desc
    keep_sorted = exclusive < top_p[:, None]
    min_kept = torch.where(keep_sorted, desc,
                           torch.full_like(desc, float("inf"))) \
        .amin(dim=-1, keepdim=True)
    keep = (probs >= min_kept) | (top_p >= 1.0)[:, None]
    return logits.masked_fill(~keep, _NEG_INF)


def filter_logits(logits, temperature, top_k, top_p, repetition_penalty,
                  history, valid):
    """The processors in order on ``[S, V]`` fp32 logits: repetition
    penalty, temperature, then top-k and top-p from ONE descending sort,
    both thresholds applied together."""
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


_MASK64 = (1 << 64) - 1


def _stream_seed(seed, position):
    """splitmix64 of (seed, position): every bit of the generator seed
    depends on both (the CPU generator keeps only the low 32 bits)."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(position) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _gumbel(seed, position, vocab, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(_stream_seed(seed, position))
    u = torch.rand(vocab, generator=gen, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_tokens(logits, temperature, top_k, top_p, repetition_penalty,
                  seeds, positions, history, valid, logprobs_topk=0):
    """The sampler head over ``[S, V]`` logits on the engine's device. The
    per-slot config (``temperature``, ``top_k``, ``top_p``,
    ``repetition_penalty``, ``seeds``, ``positions`` ``[S]``) and the
    context (``history``, ``valid`` ``[S, C]``) are host numpy arrays.
    Returns numpy ``(next_token [S] int32, chosen_logprob [S] float32,
    alt_ids [S, K] int32, alt_logprobs [S, K] float32)`` with K =
    ``logprobs_topk``; the chosen logprob is under the RAW distribution."""
    logits = logits.float()
    device = logits.device
    nxt = torch.argmax(logits, dim=-1)
    rows = np.flatnonzero(np.asarray(temperature) > 0)
    if rows.size:
        # only stochastic slots pay for the sort and the draw
        idx = torch.as_tensor(rows, device=device)

        def sel(a, dtype):
            return torch.as_tensor(np.asarray(a)[rows], dtype=dtype,
                                   device=device)

        lg = filter_logits(
            logits[idx], sel(temperature, torch.float32),
            sel(top_k, torch.int64), sel(top_p, torch.float32),
            sel(repetition_penalty, torch.float32),
            sel(history, torch.int64), sel(valid, torch.bool))
        noise = torch.stack([_gumbel(seeds[r], positions[r], lg.shape[-1],
                                     device) for r in rows])
        nxt[idx] = torch.argmax(lg + noise, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    chosen = logp.gather(-1, nxt[:, None])[:, 0]
    k = int(logprobs_topk)
    if k > 0:
        alt_lps, alt_ids = torch.topk(logp, k, dim=-1)
    else:
        alt_lps = logp.new_zeros((logits.shape[0], 0))
        alt_ids = nxt.new_zeros((logits.shape[0], 0))
    return (nxt.to(torch.int32).cpu().numpy(),
            chosen.cpu().numpy().astype(np.float32),
            alt_ids.to(torch.int32).cpu().numpy(),
            alt_lps.cpu().numpy().astype(np.float32))
