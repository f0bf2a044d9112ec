"""Port parity: the sampler's filter (``csrc/sampler_filter.cu``) against
its twin and the JAX processors.

  * a numpy emulation of the kernel's algorithm, in its order of work:
    the row split over a cluster's CTAs, the penalty and temperature in
    float32, each CTA's exp(lg - its max) and their sum, the row's
    normaliser over the CTAs in one warp's fixed shuffle tree, each
    probability as an integer multiple of 2^-32, and the two radix
    selects (8-bit digits, 4 passes, MSB first: counts for top-k, masses
    for top-p) over the per-CTA histograms; its rows equal
    `sampler_filter_reference`'s bit for bit and keep exactly the tokens
    the JAX `apply_top_k` and `apply_top_p` keep, in every row whose
    top-p masses are not within `MARGIN` of top_p (`margin_cuts` allows
    one cut); in the rows inside the margin, counted, the emulation's
    and the twin's rows are each the row cut at one of the thresholds
    `margin_cuts` allows;
  * the cases: ties at the k-th value, k = 1, k >= V, top_p tiny, top_p =
    1, -1e30 entries, penalty below and above 1, greedy rows left
    unwritten, at V in {128, 1000, 2500, 50257} (one CTA a row; 3 CTAs,
    the last slice ragged; 8 CTAs, as on the serving path);
  * the kernel route refuses what the kernel does not take (meta tensors:
    shapes and types without storage).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.serving import sampling as jsamp

from paddle_tpu_torch.kernels import sampler_filter as sf

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

_THREADS, _MAX_CTAS = 1024, 8
_NEG = np.float32(-1e30)


def _plan(vocab):
    """The kernel's CTAs a row: one for every 1024 indices, at most 8."""
    return min(_MAX_CTAS, -(-vocab // _THREADS))


def _to_key(x):
    b = np.asarray(x, np.float32).view(np.uint32)
    return b ^ np.where(b & 0x80000000, np.uint32(0xFFFFFFFF),
                        np.uint32(0x80000000))


def _from_key(k):
    k = np.uint32(k)
    flip = np.uint32(0x80000000) if k & 0x80000000 else np.uint32(0xFFFFFFFF)
    return np.array([k ^ flip], np.uint32).view(np.float32)[0]


def _walk(bins, above, target, shift, prefix):
    """Warp 0's walk of one pass: the first digit from the top where the
    merged bins reach `target`; None where none does."""
    acc = above
    for d in range(255, -1, -1):
        if acc + int(bins[d]) >= target:
            return prefix | (d << shift), acc
        acc += int(bins[d])
    return None


def kernel_filter(logits, temps, top_k, top_p, pen, history, valid,
                  out=None):
    """The kernel's function in its order of work; rows with temperature
    <= 0 keep what `out` held."""
    s, v = logits.shape
    ctas = _plan(v)
    chunk = -(-v // ctas)
    out = np.full((s, v), np.nan, np.float32) if out is None else out.copy()
    for r in range(s):
        t = np.float32(temps[r])
        if not t > 0:
            continue
        seen = np.zeros(v, bool)
        seen[np.clip(history[r][valid[r]], 0, v - 1)] = True
        x = logits[r].astype(np.float32)
        p32 = np.float32(pen[r])
        x = np.where(seen, np.where(x > 0, x / p32, x * p32), x)
        lg = (x / max(t, np.float32(1e-6))).astype(np.float32)
        slices = [slice(min(v, i * chunk), min(v, (i + 1) * chunk))
                  for i in range(ctas)]
        k, p = int(top_k[r]), np.float32(top_p[r])
        need_k, need_p = k > 0, p < 1
        thresh = _NEG
        if need_k or need_p:
            mx, mn = lg.max(), lg.min()
            mass = np.zeros(v, np.uint64)
            p_target = 0
            if need_p:
                # each CTA's exp(lg - m_r) and sum Z_r; the row's
                # normaliser sum_r Z_r exp(m_r - M) in rank order
                e = np.zeros(v, np.float32)
                parts = []
                for sl in slices:
                    if sl.stop > sl.start:
                        m_r = lg[sl].max()
                        e[sl] = np.exp((lg[sl] - m_r).astype(np.float32))
                        parts.append((m_r, float(np.sum(
                            e[sl].astype(np.float64)))))
                    else:
                        parts.append((-np.inf, 0.0))
                # lane r of warp 0 holds CTA r's term; lane 0's sum over
                # a butterfly of shuffles
                terms = [z_r * np.exp(np.float64(m_r) - np.float64(mx))
                         if z_r > 0 else 0.0 for m_r, z_r in parts]
                terms += [0.0] * (32 - len(terms))
                for off in (16, 8, 4, 2, 1):
                    terms = [terms[l] + terms[l ^ off] for l in range(32)]
                z = terms[0]
                q = np.zeros(v)
                for sl, (m_r, _) in zip(slices, parts):
                    scale = np.exp(np.float64(m_r) - np.float64(mx)) \
                        * 2.0 ** 32 / z
                    q[sl] = np.rint(e[sl].astype(np.float64) * scale)
                mass = np.minimum(q, 2.0 ** 32 - 1).astype(np.uint64)
                p_target = int(np.ceil(np.float64(p) * 2.0 ** 32))
            keys = _to_key(lg)
            sel = {"k": [0, 0, min(k, v)], "p": [0, 0, p_target]}
            found_p = need_p
            for pas in range(4):
                shift = 24 - 8 * pas
                mask = 0 if pas == 0 else (0xFFFFFFFF << (shift + 8)) \
                    & 0xFFFFFFFF
                digits = (keys >> np.uint32(shift)) & np.uint32(255)
                for name, live, weight in (("k", need_k, None),
                                           ("p", found_p, mass)):
                    if not live:
                        continue
                    prefix, above, target = sel[name]
                    match = (keys & np.uint32(mask)) == np.uint32(prefix)
                    # each CTA's histogram, merged over the cluster
                    bins = np.zeros(256, np.uint64)
                    for sl in slices:
                        m = match[sl]
                        w = None if weight is None else weight[sl][m]
                        bins += np.bincount(digits[sl][m], weights=w,
                                            minlength=256).astype(np.uint64)
                    got = _walk(bins, above, target, shift, prefix)
                    if got is None:
                        found_p = False
                    else:
                        sel[name] = [got[0], got[1], target]
            k_th = _from_key(sel["k"][0]) if need_k else _NEG
            p_th = (_NEG if not need_p else
                    _from_key(sel["p"][0]) if found_p else mn)
            thresh = max(k_th, p_th)
        out[r] = np.where(lg < thresh, _NEG, lg)
    return out


def _state(s, v, seed, c=64):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((s, v))).astype(np.float32)
    history = rng.integers(0, v, (s, c)).astype(np.int32)
    valid = np.arange(c)[None, :] < rng.integers(0, c, s)[:, None]
    return logits, history, valid


# per-row configs (temperature, top_k, top_p, penalty) of each case
CASES = {
    "mixed": [(0.8, 40, 0.95, 1.0), (0.0, 40, 0.95, 1.0), (1.0, 0, 0.9, 1.3),
              (0.7, 12, 1.0, 0.8), (1.2, 0, 1.0, 1.0), (0.0, 0, 1.0, 2.0)],
    "k_one": [(0.9, 1, 1.0, 1.0), (0.9, 1, 0.5, 1.2)],
    "k_beyond_vocab": [(1.0, 10 ** 6, 1.0, 1.0), (1.0, 10 ** 6, 0.8, 1.0)],
    "p_tiny": [(0.8, 0, 1e-6, 1.0), (1.5, 0, 1e-9, 0.7)],
    "p_one": [(0.8, 0, 1.0, 1.0), (0.8, 5, 1.0, 1.5)],
    "ties": [(1.0, 7, 1.0, 1.0), (1.0, 3, 0.6, 1.0), (1.0, 0, 0.3, 1.0)],
    "masked": [(0.8, 40, 0.95, 1.0), (0.9, 0, 0.5, 1.3), (1.0, 3, 1.0, 1.0)],
    "penalty": [(1.0, 0, 0.9, 0.5), (1.0, 20, 0.95, 3.0), (0.6, 0, 1.0, 1.7)],
}


def _case(case, v):
    rows = CASES[case]
    s = len(rows)
    logits, history, valid = _state(s, v, seed=v + len(case))
    if case == "ties":
        # few distinct values: ties at the k-th value and across the top-p
        # boundary
        logits = np.round(logits).astype(np.float32)
    elif case == "masked":
        logits[:, ::3] = -1e30                 # entries an earlier mask set
        logits[2, 5:] = -1e30                  # a row with 5 live entries
    elif case == "penalty":
        valid[:] = True
    cfg = np.array(rows, np.float64).T
    return (logits, cfg[0].astype(np.float32), cfg[1].astype(np.int32),
            cfg[2].astype(np.float32), cfg[3].astype(np.float32), history,
            valid)


def _jax_keep(logits, temps, top_k, top_p, pen, history, valid):
    """The tokens the JAX processors keep: the penalty, the temperature,
    then apply_top_k's and apply_top_p's survivors on the same logits."""
    j = jnp.asarray
    pre = jsamp.apply_temperature(
        jsamp.apply_repetition_penalty(j(logits), j(history), j(valid),
                                       j(pen)), j(temps))
    return ((np.asarray(jsamp.apply_top_k(pre, j(top_k))) > -1e29)
            & (np.asarray(jsamp.apply_top_p(pre, j(top_p))) > -1e29))


# every case at V = 128 and 1000 (the kernel's plan: one CTA a row) and
# 2500 (3 CTAs, the last slice ragged); at V = 50257 (8 CTAs, as on the
# serving path) the three that stress the histograms
GRID = ([(case, v) for case in CASES for v in (128, 1000, 2500)]
        + [(case, 50257) for case in ("mixed", "ties", "masked")])


def _cut(lg, c):
    return lg.masked_fill(lg < c, -1e30).numpy().view(np.uint32)


@pytest.mark.parametrize("case,vocab", GRID)
def test_emulation_equals_twin_and_jax(case, vocab):
    args = _case(case, vocab)
    logits, temps = args[0], args[1]
    t = torch.from_numpy
    want = sf.sampler_filter_reference(*map(t, args)).numpy()
    got = kernel_filter(*args, out=np.full_like(logits, 7.0))
    lg, cuts = sf.margin_cuts(*map(t, args))
    keep = _jax_keep(logits, temps, args[2], args[3], args[4], args[5],
                     args[6])
    inside = 0
    for r in range(len(temps)):
        if not temps[r] > 0:
            # greedy rows: left as they were
            assert np.all(got[r] == 7.0), r
            assert cuts[r] == [], r
            continue
        allowed = [_cut(lg[r], c) for c in cuts[r]]
        for name, row in (("emulation", got[r]), ("twin", want[r])):
            assert any(np.array_equal(row.view(np.uint32), a)
                       for a in allowed), (name, r, cuts[r])
        if len(cuts[r]) > 1:
            inside += 1
            continue
        np.testing.assert_array_equal(got[r].view(np.uint32),
                                      want[r].view(np.uint32), err_msg=r)
        np.testing.assert_array_equal(got[r] > -1e29, keep[r], err_msg=r)
    # the cases are built so that the margin leaves most rows to check
    assert inside <= len(temps) // 2, inside


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", ["logits_dtype", "temperature_shape",
                                 "top_k_dtype", "history_dtype",
                                 "valid_shape", "out_shape",
                                 "strided_logits", "vocab_too_large"])
def test_kernel_route_refuses(bad):
    s, v, c = 4, 64, 16
    args = dict(logits=_meta((s, v), torch.float32),
                temperature=_meta((s,), torch.float32),
                top_k=_meta((s,), torch.int32),
                top_p=_meta((s,), torch.float32),
                repetition_penalty=_meta((s,), torch.float32),
                history=_meta((s, c), torch.int32),
                valid=_meta((s, c), torch.bool), out=None)
    if bad == "logits_dtype":
        args["logits"] = _meta((s, v), torch.bfloat16)
    elif bad == "temperature_shape":
        args["temperature"] = _meta((s + 1,), torch.float32)
    elif bad == "top_k_dtype":
        args["top_k"] = _meta((s,), torch.int64)
    elif bad == "history_dtype":
        args["history"] = _meta((s, c), torch.int64)
    elif bad == "valid_shape":
        args["valid"] = _meta((s, c + 1), torch.bool)
    elif bad == "out_shape":
        args["out"] = _meta((s, v + 1), torch.float32)
    elif bad == "strided_logits":
        args["logits"] = _meta((s, 2 * v), torch.float32)[:, ::2]
    else:
        args["logits"] = _meta((s, sf.MAX_VOCAB + 1), torch.float32)
    with pytest.raises(ValueError):
        sf.sampler_filter(**args)


def test_cpu_wrapper_is_the_twin_and_keeps_out():
    """On the CPU the wrapper is the twin, written into the buffer it is
    given (every row on the CPU)."""
    args = [torch.from_numpy(a) for a in _case("mixed", 128)]
    out = torch.zeros(args[0].shape)
    got = sf.sampler_filter(*args, out=out)
    assert got is out
    torch.testing.assert_close(out, sf.sampler_filter_reference(*args),
                               rtol=0, atol=0)
