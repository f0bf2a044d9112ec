"""Per-slot sampler head of the serving engine.

Counterpart of `paddle_tpu/serving/sampling.py`. Masking order follows the
de-facto contract (HF logits processors): repetition penalty ->
temperature -> top-k -> top-p, then a Gumbel-max draw over the surviving
logits. ``top_k=0`` and ``top_p>=1`` are exact no-ops, and a slot with
``temperature=0`` returns ``argmax`` of the RAW logits — the greedy path
is exact.

Top-k and top-p thresholds are those of one descending sort of the
post-temperature logits and are applied together, as in the JAX
`sample_tokens` (top-p is measured on the full distribution, not on the
top-k survivors): `kernels/sampler_filter.py`, one kernel on the card (no
sort: radix select), its sort-based twin on the CPU.

The draw is the reference's: each stochastic slot draws Gumbel-max noise
keyed by ``fold_in(PRNGKey(seed), position)``, where ``position`` is the
count of known context tokens at sampling time (`kernels/keyed_draw.py`:
one kernel on the card, its twin on the CPU, bit for bit with
`jax.random`). Replays (preemption re-prefill) restore the same positions,
so a given (seed, prompt, sampler config) reproduces its token stream
byte-identically, and the stream is the JAX engine's wherever the two
packages' logits rank the same.
"""
from __future__ import annotations

import zlib

import torch

from ..kernels.keyed_draw import keyed_draw
from ..kernels.sampler_filter import sampler_filter

__all__ = ["validate_sampler", "default_seed", "apply_top_k", "apply_top_p",
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


def sample_tokens(logits, temperature, top_k, top_p, repetition_penalty,
                  seeds, positions, history, valid, logprobs_topk=0,
                  out=None, feedback=None, greedy_only=False, filtered=None):
    """The sampler head over ``[S, V]`` logits. Every input is a tensor on
    the logits' device: the per-slot config (``temperature``, ``top_k``,
    ``top_p``, ``repetition_penalty``, ``seeds`` (int32 holding the uint32
    seed) and ``positions`` ``[S]``) and the context (``history``,
    ``valid`` ``[S, C]``). Every row is computed (no data-dependent shape,
    no host read), so the head runs inside the decode step's CUDA graph;
    a greedy row (temperature 0) takes the argmax of the raw logits.
    Returns device tensors ``(next_token [S] int32, chosen_logprob [S]
    float32, alt_ids [S, K] int32, alt_logprobs [S, K] float32)``, K =
    ``logprobs_topk``, the logprobs under the RAW distribution. With
    `out`, a tuple of four such tensors, the results are written there
    (the token by the keyed draw itself) and `out` is returned;
    `feedback` ``[S]`` int32 also receives the token; `filtered`, an
    ``[S, V]`` fp32 buffer, receives the processors' output (a fresh
    tensor when None). With `greedy_only` (the caller knows no row
    samples) every row is decided greedily and the processors are
    skipped; each greedy row's outputs are those of the full head, bit for
    bit. On the card the full head is two kernels (`sampler_filter`, then
    `keyed_draw`) besides the ops both heads share."""
    logits = logits.float().contiguous()
    if greedy_only:
        temperature = torch.zeros_like(temperature)
        filtered = logits
    else:
        filtered = sampler_filter(logits, temperature, top_k, top_p,
                                  repetition_penalty, history, valid,
                                  out=filtered)
    nxt = keyed_draw(logits, filtered, temperature, seeds, positions,
                     out=None if out is None else out[0], feedback=feedback)
    logp = torch.log_softmax(logits, dim=-1)
    chosen = logp.gather(-1, nxt.long()[:, None])[:, 0]
    k = int(logprobs_topk)
    if k > 0:
        alt_lps, alt_ids = torch.topk(logp, k, dim=-1)
        alt_ids = alt_ids.to(torch.int32)
    else:
        alt_lps = logp.new_zeros((logits.shape[0], 0))
        alt_ids = nxt.new_zeros((logits.shape[0], 0))
    if out is None:
        return nxt, chosen, alt_ids, alt_lps
    for dst, src in zip(out[1:], (chosen, alt_ids, alt_lps)):
        if dst.numel():
            dst.copy_(src)
    return out
