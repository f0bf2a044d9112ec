"""Port parity: the keyed draw and the sampler head against `jax.random`
and the JAX `sample_tokens`.

  * the twin's threefry keys (``fold_in(PRNGKey(seed), position)``), its
    random bits, its uniforms and its Gumbel noise are bit-identical to
    `jax.random`'s (jax 0.9.0, partitionable threefry) over many (seed,
    position, V), and `xla_log` to XLA's CPU ``log`` over a sweep of
    float32 values with the special ones;
  * `keyed_draw_reference` draws `jax.random.categorical`'s token per row,
    and a greedy row the raw argmax;
  * the port's `sample_tokens` equals the JAX `sample_tokens` on the same
    logits and per-slot config: tokens equal, logprobs within 1e-5
    (float32, the same log-softmax written twice), and its greedy head
    (`greedy_only`, no sort) gives every greedy row the full head's
    outputs bit for bit;
  * the reduction of ``csrc/keyed_draw.cu`` (a cluster of CTAs a slot,
    each a slice of the row: strided per-thread bests, warp shuffles, one
    warp over the warps, then rank 0 over the CTAs' pairs) picks the first
    argmax, ties and NaN included (a numpy emulation of its order of
    work);
  * the CPU wrapper writes the output, feedback and debug buffers, and the
    kernel route refuses what the kernel does not take (meta tensors:
    shapes and types without storage).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.serving import sampling as jsamp

from paddle_tpu_torch.kernels import keyed_draw as kd
from paddle_tpu_torch.serving import sampling as tsamp

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

# (seed, position) pairs: 0 and the uint32 extremes, small and large
# positions
KEY_CASES = [(0, 0), (0, 1), (1, 5), (7, 100), (2 ** 31 - 1, 1023),
             (2 ** 31, 1024), (2 ** 32 - 1, 2 ** 31 - 1), (123456789, 77),
             (3735928559, 50256), (42, 2 ** 20)]
VOCABS = [1, 7, 128, 1000, 50257]


def _jax_key(seed, position):
    return jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                              np.int32(position))


def _t(values, dtype):
    """uint32 values as a torch tensor of `dtype` (int32: the same bits)."""
    arr = np.asarray(values, np.uint64).astype(np.uint32)
    return torch.from_numpy(arr.view(np.int32)).to(dtype)


def test_threefry_partitionable_is_on():
    # the twin ports the partitionable bit layout; this is the default of
    # the installed jax and the reference never changes it
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed,position", KEY_CASES)
def test_slot_keys_match_fold_in(seed, position):
    k0, k1 = kd.slot_keys(_t([seed], torch.int32),
                          torch.tensor([position], dtype=torch.int32))
    want = np.asarray(jax.random.key_data(_jax_key(seed, position)))
    assert [int(k0[0]), int(k1[0])] == want.tolist()


@pytest.mark.parametrize("vocab", VOCABS)
def test_bits_uniform_and_noise_bit_identical(vocab):
    seeds = _t([s for s, _ in KEY_CASES], torch.int64)
    positions = torch.tensor([p for _, p in KEY_CASES], dtype=torch.int64)
    k0, k1 = kd.slot_keys(seeds, positions)
    bits = kd.random_bits(k0, k1, vocab)
    u = kd.uniform(bits)
    noise = kd.gumbel(seeds, positions, vocab)
    tiny = np.finfo(np.float32).tiny
    for row, (seed, position) in enumerate(KEY_CASES):
        key = _jax_key(seed, position)
        want_bits = np.asarray(jax.random.bits(key, (vocab,), jnp.uint32))
        np.testing.assert_array_equal(
            bits[row].numpy().astype(np.uint32), want_bits)
        want_u = np.asarray(jax.random.uniform(key, (vocab,), jnp.float32,
                                               minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(u[row].numpy().view(np.uint32),
                                      want_u.view(np.uint32))
        want_g = np.asarray(jax.random.gumbel(key, (vocab,), jnp.float32))
        np.testing.assert_array_equal(noise[row].numpy().view(np.uint32),
                                      want_g.view(np.uint32))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-100.0, 0.0), (-87.0, 88.0)])
def test_xla_log_bit_identical(lo, hi):
    rng = np.random.default_rng(int(hi - lo))
    x = np.exp(rng.uniform(lo, hi, 200_000)).astype(np.float32)
    fi = np.finfo(np.float32)
    x = np.concatenate([x, np.float32([0.0, -0.0, 1.0, 2.0, np.inf, -1.0,
                                       np.nan, 1e-40, fi.tiny, fi.max])])
    got = kd.xla_log(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.log(jnp.asarray(x)))
    both_nan = np.isnan(got) & np.isnan(want)
    np.testing.assert_array_equal(np.where(both_nan, 0, got.view(np.uint32)),
                                  np.where(both_nan, 0, want.view(np.uint32)))


def _logits(s, v, seed):
    rng = np.random.default_rng(seed)
    return (3.0 * rng.standard_normal((s, v))).astype(np.float32)


@pytest.mark.parametrize("vocab", [7, 128, 50257])
def test_reference_draw_is_jax_categorical(vocab):
    s = len(KEY_CASES)
    raw = _logits(s, vocab, vocab)
    filtered = raw.copy()
    filtered[:, ::3] = -1e30               # masked entries, as the filter does
    temps = np.where(np.arange(s) % 3 == 0, 0.0, 0.8).astype(np.float32)
    seeds = [seed for seed, _ in KEY_CASES]
    positions = [p for _, p in KEY_CASES]
    got = kd.keyed_draw_reference(
        torch.from_numpy(raw), torch.from_numpy(filtered),
        torch.from_numpy(temps), _t(seeds, torch.int32),
        torch.tensor(positions, dtype=torch.int32)).numpy()
    for row in range(s):
        if temps[row] > 0:
            want = int(jax.random.categorical(
                _jax_key(seeds[row], positions[row]),
                jnp.asarray(filtered[row])))
        else:
            want = int(raw[row].argmax())
        assert got[row] == want, row


# per-slot configs: greedy, each processor alone, all together
CONFIGS = [dict(temperature=0.0), dict(temperature=0.7),
           dict(temperature=1.0, top_k=12), dict(temperature=0.9, top_p=0.85),
           dict(temperature=1.1, top_k=24, top_p=0.9,
                repetition_penalty=1.3),
           dict(temperature=1.5, top_k=1), dict(temperature=0.3, top_p=0.2,
                                                 repetition_penalty=0.8),
           dict(temperature=0.0, top_k=5, repetition_penalty=2.0)]


@pytest.mark.parametrize("vocab", [128, 1000])
@pytest.mark.parametrize("topk_panel", [0, 3])
@pytest.mark.parametrize("draw", range(3))
def test_sample_tokens_matches_jax(vocab, topk_panel, draw):
    s, c = len(CONFIGS), 24
    rng = np.random.default_rng(100 * draw + vocab)
    logits = _logits(s, vocab, draw)
    temps = np.array([cfg.get("temperature", 0.0) for cfg in CONFIGS],
                     np.float32)
    top_k = np.array([cfg.get("top_k", 0) for cfg in CONFIGS], np.int32)
    top_p = np.array([cfg.get("top_p", 1.0) for cfg in CONFIGS], np.float32)
    pen = np.array([cfg.get("repetition_penalty", 1.0) for cfg in CONFIGS],
                   np.float32)
    seeds = rng.integers(0, 2 ** 32, s, dtype=np.uint64).astype(np.uint32)
    lens = rng.integers(0, c, s).astype(np.int32)
    history = rng.integers(0, vocab, (s, c)).astype(np.int32)
    valid = np.arange(c)[None, :] <= lens[:, None]
    positions = lens + 1
    want = jsamp.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_k),
        jnp.asarray(top_p), jnp.asarray(pen), jnp.asarray(seeds),
        jnp.asarray(positions), jnp.asarray(history), jnp.asarray(valid),
        logprobs_topk=topk_panel)
    t = torch.from_numpy
    got = tsamp.sample_tokens(
        t(logits), t(temps), t(top_k), t(top_p), t(pen),
        t(seeds.view(np.int32)), t(positions), t(history), t(valid),
        logprobs_topk=topk_panel)
    nxt, chosen, alt_ids, alt_lps = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), nxt)
    np.testing.assert_allclose(got[1].numpy(), chosen, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), alt_ids)
    np.testing.assert_allclose(got[3].numpy(), alt_lps, rtol=0, atol=1e-5)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32


def test_sample_tokens_writes_out_and_feedback():
    s, v, k = 4, 64, 2
    logits = torch.from_numpy(_logits(s, v, 9))
    temps = torch.tensor([0.0, 0.8, 1.0, 0.0])
    ints = torch.zeros(s, dtype=torch.int32)
    out = (torch.full((s,), -1, dtype=torch.int32), torch.zeros(s),
           torch.zeros((s, k), dtype=torch.int32), torch.zeros((s, k)))
    feedback = torch.full((s,), -1, dtype=torch.int32)
    args = (logits, temps, ints, torch.ones(s), torch.ones(s),
            torch.arange(s, dtype=torch.int32), ints + 3,
            torch.zeros((s, 1), dtype=torch.int32),
            torch.zeros((s, 1), dtype=torch.bool))
    want = tsamp.sample_tokens(*args, logprobs_topk=k)
    got = tsamp.sample_tokens(*args, logprobs_topk=k, out=out,
                              feedback=feedback)
    assert got is out
    for a, b in zip(out, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(feedback, want[0], rtol=0, atol=0)


@pytest.mark.parametrize("vocab", [128, 1000])
@pytest.mark.parametrize("topk_panel", [0, 3])
def test_greedy_head_equals_the_full_head_on_greedy_rows(vocab, topk_panel):
    """`greedy_only` (the decode step's head when no launched slot samples)
    decides every row by its raw argmax, and on each greedy row its token,
    logprob and alternatives are the full head's, bit for bit."""
    s, c = len(CONFIGS), 24
    rng = np.random.default_rng(vocab + topk_panel)
    t = torch.from_numpy
    args = (t(_logits(s, vocab, 5)),
            t(np.array([cfg.get("temperature", 0.0) for cfg in CONFIGS],
                       np.float32)),
            t(np.array([cfg.get("top_k", 0) for cfg in CONFIGS], np.int32)),
            t(np.array([cfg.get("top_p", 1.0) for cfg in CONFIGS],
                       np.float32)),
            t(np.array([cfg.get("repetition_penalty", 1.0)
                        for cfg in CONFIGS], np.float32)),
            t(rng.integers(-2 ** 31, 2 ** 31, s).astype(np.int32)),
            t(rng.integers(1, c, s).astype(np.int32)),
            t(rng.integers(0, vocab, (s, c)).astype(np.int32)),
            t(np.ones((s, c), bool)))
    full = tsamp.sample_tokens(*args, logprobs_topk=topk_panel)
    greedy = tsamp.sample_tokens(*args, logprobs_topk=topk_panel,
                                 greedy_only=True)
    torch.testing.assert_close(greedy[0], args[0].argmax(-1).to(torch.int32),
                               rtol=0, atol=0)
    rows = args[1] <= 0
    assert 0 < int(rows.sum()) < s
    for a, b in zip(greedy, full, strict=True):
        torch.testing.assert_close(a[rows], b[rows], rtol=0, atol=0)


def _beats(av, ai, bv, bi):
    """`beats` of csrc/keyed_draw.cu."""
    an, bn = av != av, bv != bv
    if an or bn:
        return an and (not bn or ai < bi)
    return av > bv or (av == bv and ai < bi)


def _kernel_argmax(values, threads=1024):
    """The kernel's reduction in its order: the row split over the CTAs
    of a cluster (one for every 1024 indices, at most 8), each a
    contiguous slice of ceil(V / CTAs); in each CTA, each thread's best
    over its slice's indices lo + tid, lo + tid + 1024, ...; then shuffles
    down by 16, 8, 4, 2, 1 within each warp; then warp 0 does the same
    over the warps' bests; then rank 0 merges the CTAs' pairs in rank
    order."""
    v = len(values)
    ctas = min(8, -(-v // threads))
    chunk = -(-v // ctas)

    def warp(lanes):
        # every lane reads lane + off (its own value past lane 31) before
        # any lane writes
        lanes = lanes + [(-np.inf, v)] * (32 - len(lanes))
        for off in (16, 8, 4, 2, 1):
            lanes = [lanes[l + off] if l + off < 32 and _beats(
                *lanes[l + off], *lanes[l]) else lanes[l]
                for l in range(32)]
        return lanes[0]

    parts = []
    for rank in range(ctas):
        lo, hi = min(v, rank * chunk), min(v, (rank + 1) * chunk)
        best = []
        for tid in range(threads):
            b = (-np.inf, v)
            for i in range(lo + tid, hi, threads):
                if _beats(values[i], i, *b):
                    b = (values[i], i)
            best.append(b)
        parts.append(warp([warp(best[w * 32:(w + 1) * 32])
                           for w in range(threads // 32)]))
    b = parts[0]
    for p in parts[1:]:
        if _beats(*p, *b):
            b = p
    return b[1]


@pytest.mark.parametrize("case", ["ties", "all_equal", "nan", "masked",
                                  "short_row"])
def test_kernel_reduction_is_first_argmax(case):
    # 3 CTAs of 1000 at V = 3000; 8 at V = 8500, slices of 1063 and a
    # ragged last one of 1059; one CTA for a short row
    for v in (3000, 8500):
        rng = np.random.default_rng(3)
        values = rng.integers(0, 5, v).astype(np.float32)   # many ties
        if case == "all_equal":
            values[:] = -1e30
        elif case == "nan":
            values[[2500, 1700]] = np.nan
        elif case == "masked":
            values[:] = -np.inf
            values[v - 1] = -1e30
        elif case == "short_row":
            values = values[:5]
        want = int(torch.argmax(torch.from_numpy(values)))
        got = _kernel_argmax(values.tolist())
        assert got == want, v


def test_cpu_wrapper_fills_debug_buffers():
    s, v = 3, 50
    raw = torch.from_numpy(_logits(s, v, 4))
    seeds = _t([5, 6, 7], torch.int32)
    positions = torch.tensor([1, 2, 3], dtype=torch.int32)
    debug = (torch.zeros((s, v), dtype=torch.int32), torch.zeros((s, v)))
    kd.keyed_draw(raw, raw, torch.zeros(s), seeds, positions, debug=debug)
    k0, k1 = kd.slot_keys(seeds, positions)
    bits = kd.random_bits(k0, k1, v)
    assert torch.equal(debug[0], bits.to(torch.int32))
    assert torch.equal(debug[1], kd.gumbel(seeds, positions, v))


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", ["raw_dtype", "filtered_shape",
                                 "seeds_dtype", "positions_shape",
                                 "out_dtype", "strided_raw"])
def test_kernel_route_refuses(bad):
    s, v = 4, 64
    args = dict(raw=_meta((s, v), torch.float32),
                filtered=_meta((s, v), torch.float32),
                temperature=_meta((s,), torch.float32),
                seeds=_meta((s,), torch.int32),
                positions=_meta((s,), torch.int32), out=None)
    if bad == "raw_dtype":
        args["raw"] = _meta((s, v), torch.bfloat16)
    elif bad == "filtered_shape":
        args["filtered"] = _meta((s, v + 1), torch.float32)
    elif bad == "seeds_dtype":
        args["seeds"] = _meta((s,), torch.int64)
    elif bad == "positions_shape":
        args["positions"] = _meta((s + 1,), torch.int32)
    elif bad == "out_dtype":
        args["out"] = _meta((s,), torch.int64)
    else:
        args["raw"] = _meta((s, 2 * v), torch.float32)[:, ::2]
    with pytest.raises(ValueError):
        kd.keyed_draw(**args)
