"""Port parity: the sampler's filter (``csrc/sampler_filter.cu``) against
its twin and the JAX processors.

  * a numpy emulation of the kernel's algorithm, in its order of work:
    the row split over a cluster's CTAs, the penalty and temperature in
    float32, each warp's max, each thread's float32 sum of exp(lg - the
    warp's max) over its elements, a butterfly over the warp's lanes
    (float32), warp 0's fold over the CTA's warps and the row's over the
    CTAs (fp64), then the row's route:
      - candidates (0 < k <= the warps): the bound w (the least over the
        CTAs of each CTA's ceil(k / P)-th largest warp maximum), every
        element >= w gathered in a shuffled order (the order in which the
        kernel's atomics land is not fixed), ranked, and the first k
        masses round(exp(x - M) / Z x 2^32) in an integer scan;
      - overflow (more than the cap of candidates) and radix (k = 0 with
        top_p < 1, or k above the warps): the masses round(exp(lg - m_w)
        x exp(m_w - M) x 2^32 / Z) (m_w the element's warp max) and the
        two radix selects (8-bit digits, 4 passes, MSB first: counts for
        top-k, masses for top-p) over the per-CTA histograms;
    its rows equal `sampler_filter_reference`'s bit for bit and keep
    exactly the tokens the JAX `apply_top_k` and `apply_top_p` keep, in
    every row whose top-p masses are not within `MARGIN` of top_p
    (`margin_cuts` allows one cut); in the rows inside the margin,
    counted, the emulation's and the twin's rows are each the row cut at
    one of the thresholds `margin_cuts` allows; its routes are
    `filter_routes`' (the kernel's rule in plain PyTorch), and each route
    is reached;
  * the cases: ties at the k-th value, k = 1, k >= V, k above the warps,
    ties at the candidates' bound that overflow the cap, top-p only,
    top_p tiny, top_p = 1, -1e30 entries, penalty below and above 1,
    greedy rows left unwritten, at V in {128, 1000, 2500, 50257} (one CTA
    a row; 3 CTAs, the last slice ragged; 8 CTAs, as on the serving
    path);
  * a seeded property: for top-k rows, max(k_th, p_th) taken from the k
    largest values and the full row's masses alone equals the twin's
    threshold from the whole sorted row;
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
_WARPS = _THREADS // 32
_MAX_CAND = _THREADS
_NEG = np.float32(-1e30)
_ROUTE = {name: code for code, name in enumerate(sf.ROUTES)}


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


def _butterfly(vals, combine):
    """A warp's xor butterfly over the last axis (32 lanes): lane l's
    result, the same in every lane."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        vals = combine(vals, [v[..., lanes ^ off] for v in vals])
    return vals


def _exp32(x):
    with np.errstate(invalid="ignore", over="ignore"):
        return np.exp(np.asarray(x, np.float32)).astype(np.float32)


def _cta_stats(part):
    """One CTA's statistics as the kernel folds them: ``(max, min, sum of
    exp(lg - max), warp maxima, each element's warp max, each element's
    exp(lg - its warp's max))``. Thread j takes elements j, j + 1024, ...;
    each warp's max and min over its lanes, then each thread's float32 sum
    of exp(lg - the warp's max) in order, a butterfly over the lanes
    (float32), and warp 0 over the warps (fp64)."""
    f32 = np.float32
    n = part.shape[0]
    width = max(1, -(-n // _THREADS)) * _THREADS
    pad = np.full(width, -np.inf, f32)
    pad[:n] = part
    high = np.full(width, np.inf, f32)
    high[:n] = part
    cols = pad.reshape(-1, _WARPS, 32)
    wm = cols.max(axis=(0, 2))
    wl = high.reshape(-1, _WARPS, 32).min(axis=(0, 2))
    elem_wm = np.broadcast_to(wm[None, :, None], cols.shape).reshape(-1)[:n]
    ex = np.where(elem_wm > -np.inf, _exp32(part - elem_wm), f32(0))
    e_all = np.zeros(width, f32)
    e_all[:n] = ex
    s = np.zeros(_THREADS, f32)
    for row in e_all.reshape(-1, _THREADS):
        s = (s + row).astype(f32)
    ws = _butterfly([s.reshape(_WARPS, 32)],
                    lambda a, b: [(a[0] + b[0]).astype(f32)])[0][:, 0]
    m_r = wm.max()
    terms = np.where(ws > 0, ws.astype(np.float64)
                     * _exp32(wm - m_r).astype(np.float64), 0.0)
    z = _butterfly([terms], lambda a, b: [a[0] + b[0]])[0][0]
    return m_r, wl.min(), z, wm, elem_wm, ex


def _row_normaliser(parts, big):
    """Warp 0 of a CTA over the CTAs' (max, sum) pairs: lane r holds CTA
    r's sum times exp(its max - M), summed in a butterfly (fp64)."""
    terms = np.zeros(32)
    for r, (m_r, _, z_r, *_) in enumerate(parts):
        if z_r > 0:
            terms[r] = z_r * np.float64(_exp32(m_r - big))
    return _butterfly([terms], lambda a, b: [a[0] + b[0]])[0][0]


def _radix(lg, slices, parts, big, small, z, k, p, need_k, need_p):
    """The radix route's threshold: masses round(exp(lg - m_w) x exp(m_w
    - M) x 2^32 / Z), m_w the element's warp max; two selects over the
    merged histograms."""
    v = lg.shape[0]
    mass = np.zeros(v, np.uint64)
    p_target = int(np.ceil(np.float64(p) * 2.0 ** 32)) if need_p and p > 0 \
        else 0
    live_p = need_p and p_target > 0
    if live_p:
        row_scale = 2.0 ** 32 / z
        q = np.zeros(v)
        for sl, (*_, elem_wm, ex) in zip(slices, parts):
            scale = np.where(elem_wm > -np.inf,
                             _exp32(elem_wm - big).astype(np.float64)
                             * row_scale, 0.0)
            q[sl] = np.rint(ex.astype(np.float64) * scale)
        mass = np.minimum(q, 2.0 ** 32 - 1).astype(np.uint64)
    keys = _to_key(lg)
    sel = {"k": [0, 0, k if need_k else 0], "p": [0, 0, p_target]}
    found_p = live_p
    for pas in range(4):
        shift = 24 - 8 * pas
        mask = 0 if pas == 0 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
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
                mm = match[sl]
                w = None if weight is None else weight[sl][mm]
                bins += np.bincount(digits[sl][mm], weights=w,
                                    minlength=256).astype(np.uint64)
            got = _walk(bins, above, target, shift, prefix)
            if got is None:
                found_p = False
            else:
                sel[name] = [got[0], got[1], target]
    k_th = _from_key(sel["k"][0]) if need_k else _NEG
    p_th = (_NEG if not need_p else big if not live_p
            else _from_key(sel["p"][0]) if found_p else small)
    return max(k_th, p_th)


def _candidates(lg, parts, big, z, k, p, need_p, rng):
    """The candidates route's threshold, or None where they overflow:
    the bound w, the candidates in a shuffled order, ranked (values, then
    slots), the first k masses round(exp(x - M) / Z x 2^32) and their
    integer scan."""
    quota = -(-k // len(parts))
    w = min(np.sort(wm)[::-1][quota - 1] for _, _, _, wm, *_ in parts)
    cand = lg[lg >= w]
    if cand.shape[0] > _MAX_CAND:
        return None
    cand = cand[rng.permutation(cand.shape[0])]
    top = cand[np.argsort(-cand, kind="stable")][:k]
    if not need_p:
        return top[k - 1]
    m = np.minimum(np.rint(np.exp(top.astype(np.float64) - np.float64(big))
                           * (2.0 ** 32 / z)), 2.0 ** 32 - 1) \
        .astype(np.uint64)
    incl = np.cumsum(m)
    excl = incl - m
    target = int(np.ceil(np.float64(p) * 2.0 ** 32)) if p > 0 else 0
    n_lt = int((excl < target).sum())
    return top[k - 1] if n_lt == k else top[max(n_lt, 1) - 1]


def kernel_filter(logits, temps, top_k, top_p, pen, history, valid,
                  out=None, seed=0):
    """The kernel's function in its order of work: ``(out, routes)``;
    rows with temperature <= 0 keep what `out` held."""
    s, v = logits.shape
    ctas = _plan(v)
    chunk = -(-v // ctas)
    rng = np.random.default_rng(seed)
    out = np.full((s, v), np.nan, np.float32) if out is None else out.copy()
    routes = np.zeros(s, np.int32)
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
        k, p = min(int(top_k[r]), v), np.float32(top_p[r])
        need_k, need_p = k > 0, p < 1
        if not (need_k or need_p):
            routes[r] = _ROUTE["uncut"]
            out[r] = lg
            continue
        parts = [_cta_stats(lg[sl]) for sl in slices]
        big = max(m_r for m_r, *_ in parts)
        small = min(lo_r for _, lo_r, *_ in parts)
        z = _row_normaliser(parts, big)
        thresh = None
        if need_k and k <= ctas * _WARPS:
            thresh = _candidates(lg, parts, big, z, k, p, need_p, rng)
            routes[r] = _ROUTE["candidates" if thresh is not None
                               else "overflow"]
        else:
            routes[r] = _ROUTE["radix"]
        if thresh is None:
            thresh = _radix(lg, slices, parts, big, small, z, k, p, need_k,
                            need_p)
        out[r] = np.where(lg < thresh, _NEG, lg)
    return out, routes


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
    # k above the warps (32 a CTA): the radix route at every V but 2500's
    # k = 40 and 50257's k <= 256
    "k_above_warps": [(1.0, 300, 1.0, 1.0), (0.9, 300, 0.9, 1.0),
                      (1.0, 100, 0.95, 1.0), (0.8, 40, 0.9, 1.2)],
    # logits of three values (round(0.3 x N(0, 1))): ties at the bound
    # push more than the cap of candidates where V > 1024
    "overflow": [(1.0, 90, 1.0, 1.0), (0.9, 90, 0.9, 1.0),
                 (1.0, 5, 0.9, 1.0), (0.0, 90, 0.9, 1.0)],
    "top_p_only": [(1.0, 0, 0.9, 1.0), (0.7, 0, 0.5, 1.2),
                   (1.3, 0, 0.99, 1.0), (0.0, 0, 0.9, 1.0)],
}


def _case(case, v):
    rows = CASES[case]
    s = len(rows)
    logits, history, valid = _state(s, v, seed=v + len(case))
    if case == "ties":
        # few distinct values: ties at the k-th value and across the top-p
        # boundary
        logits = np.round(logits).astype(np.float32)
    elif case == "overflow":
        logits = np.round(0.1 * logits).astype(np.float32)
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
# serving path) those that stress the histograms and each route
GRID = ([(case, v) for case in CASES for v in (128, 1000, 2500)]
        + [(case, 50257) for case in ("mixed", "ties", "masked",
                                      "k_above_warps", "overflow")])


def _cut(lg, c):
    return lg.masked_fill(lg < c, -1e30).numpy().view(np.uint32)


@pytest.mark.parametrize("case,vocab", GRID)
def test_emulation_equals_twin_and_jax(case, vocab):
    args = _case(case, vocab)
    logits, temps = args[0], args[1]
    t = torch.from_numpy
    want = sf.sampler_filter_reference(*map(t, args)).numpy()
    got, routes = kernel_filter(*args, out=np.full_like(logits, 7.0),
                                seed=vocab)
    np.testing.assert_array_equal(routes,
                                  sf.filter_routes(*map(t, args)).numpy())
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


# where each route must be reached: (case, V) -> route -> rows
ROUTE_COUNTS = {
    ("mixed", 2500): {"greedy": 2, "uncut": 1, "candidates": 2, "radix": 1},
    ("k_above_warps", 128): {"radix": 4},
    ("k_above_warps", 2500): {"radix": 3, "candidates": 1},
    ("k_above_warps", 50257): {"radix": 2, "candidates": 2},
    ("overflow", 1000): {"radix": 2, "candidates": 1, "greedy": 1},
    ("overflow", 2500): {"overflow": 2, "candidates": 1, "greedy": 1},
    ("overflow", 50257): {"overflow": 3, "greedy": 1},
    ("top_p_only", 2500): {"radix": 3, "greedy": 1},
    ("k_one", 50257): {"candidates": 2},
}


@pytest.mark.parametrize("case,vocab", sorted(ROUTE_COUNTS))
def test_each_route_is_reached(case, vocab):
    """The cases reach every route: the emulation's routes, counted, and
    the wrapper's on the CPU (`filter_routes`) agree."""
    args = _case(case, vocab)
    _, routes = kernel_filter(*args, seed=vocab)
    counts = {sf.ROUTES[c]: int((routes == c).sum()) for c in set(routes)}
    assert counts == ROUTE_COUNTS[case, vocab], counts
    got = torch.full((len(routes),), -1, dtype=torch.int32)
    sf.sampler_filter(*map(torch.from_numpy, args), routes=got)
    np.testing.assert_array_equal(got.numpy(), routes)


def _threshold_from_top_k(desc, exclusive, k, p):
    """max(k_th, p_th) from the k largest values and their exclusive
    masses alone (n_keep >= k: k_th; else p_th = desc[n_keep - 1])."""
    n_lt = int((exclusive[:k] < p).sum())
    return desc[k - 1] if n_lt == k else desc[max(n_lt, 1) - 1]


@pytest.mark.parametrize("seed", range(24))
def test_threshold_from_top_k_candidates(seed):
    """For a top-k row, the twin's threshold max(k_th, p_th) over the
    whole sorted row equals the one taken from its k largest values and
    the full row's masses, at random vocabularies, k, top_p (1 in some
    rows), temperatures and ties."""
    rng = np.random.default_rng(1000 + seed)
    s = 6
    v = int(rng.integers(2, 4000))
    logits = (rng.uniform(0.5, 6) * rng.standard_normal((s, v))) \
        .astype(np.float32)
    if seed % 3 == 0:
        logits = np.round(logits).astype(np.float32)
    top_k = rng.integers(1, min(v, 300) + 1, s).astype(np.int32)
    top_p = np.where(rng.random(s) < 0.25, 1.0,
                     rng.uniform(0.01, 0.999, s)).astype(np.float32)
    temps = rng.uniform(0.3, 1.5, s).astype(np.float32)
    history = np.zeros((s, 1), np.int32)
    valid = np.zeros((s, 1), bool)
    args = [torch.from_numpy(a) for a in (logits, temps, top_k, top_p,
                                          np.ones(s, np.float32), history,
                                          valid)]
    want = sf.sampler_filter_reference(*args)
    lg = sf.apply_temperature(args[0], args[1])
    desc = torch.sort(lg, dim=-1, descending=True).values
    p_desc = torch.softmax(desc, dim=-1)
    exclusive = torch.cumsum(p_desc, dim=-1) - p_desc
    for r in range(s):
        k = int(top_k[r])
        if top_p[r] < 1:
            thresh = _threshold_from_top_k(desc[r], exclusive[r], k,
                                           float(top_p[r]))
        else:
            thresh = desc[r, k - 1]
        got = lg[r].masked_fill(lg[r] < thresh, -1e30)
        assert torch.equal(got.view(torch.int32), want[r].view(torch.int32)), r


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", ["logits_dtype", "temperature_shape",
                                 "top_k_dtype", "history_dtype",
                                 "valid_shape", "out_shape",
                                 "strided_logits", "vocab_too_large",
                                 "routes_dtype"])
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
    elif bad == "routes_dtype":
        args["routes"] = _meta((s,), torch.int64)
    else:
        args["logits"] = _meta((s, sf.MAX_VOCAB + 1), torch.float32)
    with pytest.raises(ValueError):
        sf.sampler_filter(**args)


def test_cpu_wrapper_is_the_twin_and_keeps_out():
    """On the CPU the wrapper is the twin, written into the buffer it is
    given (every row on the CPU), and fills the routes it is given with
    the kernel's rule."""
    args = [torch.from_numpy(a) for a in _case("mixed", 128)]
    out = torch.zeros(args[0].shape)
    routes = torch.full((args[0].shape[0],), -1, dtype=torch.int32)
    got = sf.sampler_filter(*args, out=out, routes=routes)
    assert got is out
    torch.testing.assert_close(out, sf.sampler_filter_reference(*args),
                               rtol=0, atol=0)
    assert routes.tolist() == [4, 0, 4, 2, 1, 0]
