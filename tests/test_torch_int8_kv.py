"""Port parity: paddle_tpu_torch int8 KV serving vs the JAX package's.

  * the int8 write paths (`quantize_scatter`, `quantize_block_write`) and
    `dequantize`: on the same fp32 inputs the port's int8 levels are
    IDENTICAL to the JAX functions' and its scales equal within 1e-7
    relative (the same elementwise fp32 arithmetic in the same order,
    round half to even on both sides);
  * the paged decode twin with int8 pools and scales against the Pallas
    kernel in interpret mode (and the dense oracle): 1e-5 (fp32; both
    dequantize the same levels in fp32 and differ only in summation
    order), and one whole decode step (int8 write + attention) against
    the JAX `paged_decode_attention`; the kernel's split-K arithmetic
    (partials per span, merged in split order) against the same step;
  * the port's int8 `LLMEngine(device="cpu")` is token-identical to the
    JAX int8 engine on the same converted weights, including a tight pool
    that evicts and re-prefills (mirrors tests/test_kernel_tier.py's
    int8 cases), and the same pool bytes admit >= 1.8x the streams.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.kernels.pallas.paged_attention import pallas_paged_attention
from paddle_tpu.nn.functional.attention import \
    paged_decode_attention as j_paged
from paddle_tpu.quantization import kv_cache as jq
from paddle_tpu.serving import LLMEngine as JLLMEngine

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.kernels.paged_attention import (
    paged_attention, paged_decode_reference)
from paddle_tpu_torch.nn.functional import paged_decode_attention as t_paged
from paddle_tpu_torch.nn.functional.attention import _dense_gather_attention
from paddle_tpu_torch.quantization import kv_cache as tq
from paddle_tpu_torch.serving import (LLMEngine, PagedKVCache,
                                      num_blocks_for_bytes, scatter_prefill)

# fp32 attention outputs: blockwise online softmax vs the kernel's per-block
# recurrence or a dense softmax, over the same dequantized values
TOL = dict(rtol=1e-5, atol=1e-5)
# stored scales: the same amax of the same fp32 values (exact in practice)
SCALE_RTOL = 1e-7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# write paths: identical int8 levels
# ---------------------------------------------------------------------------

def _scatter_inputs(t, length, seed, bs=4, h=3, d=8, nb=9):
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal((t, h, d))
            * rng.uniform(0.1, 10.0, (t, 1, 1))).astype(np.float32)
    pool = rng.integers(-127, 128, (nb, bs, h, d)).astype(np.int8)
    scales = np.full((nb, h), 7.7, np.float32)      # a stale tenant's scale
    block_row = np.asarray([1, 2, 3, 4, 5, 6, 0, 0], np.int32)
    pidx = np.arange(t)
    blocks = np.where(pidx < length, block_row[pidx // bs], 0) \
        .astype(np.int32)
    offs = (pidx % bs).astype(np.int32)
    return vals, pool, scales, blocks, offs, block_row


@pytest.mark.parametrize("t,length,seed", [(24, 22, 3), (24, 24, 4),
                                           (8, 1, 5), (16, 13, 6)])
def test_quantize_scatter_levels_match_jax(t, length, seed):
    vals, pool, scales, blocks, offs, row = _scatter_inputs(t, length, seed)
    j_pool, j_sc = jq.quantize_scatter(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(vals),
        jnp.asarray(blocks), jnp.asarray(offs), jnp.asarray(row),
        jnp.int32(length))
    t_pool, t_sc = _t(pool.copy()), _t(scales.copy())
    out = tq.quantize_scatter(t_pool, t_sc, _t(vals), _t(blocks), _t(offs),
                              _t(row), length)
    assert out[0] is t_pool and out[1] is t_sc          # written in place
    np.testing.assert_array_equal(t_pool.numpy(), np.asarray(j_pool))
    np.testing.assert_allclose(t_sc.numpy(), np.asarray(j_sc),
                               rtol=SCALE_RTOL, atol=0)
    np.testing.assert_array_equal(
        tq.dequantize(t_pool, t_sc).numpy(),
        np.asarray(jq.dequantize(j_pool, j_sc)))


def _near_ties(n, seed=0):
    """(amax, value) fp32 pairs whose level ``round(value * (127 / amax))``
    changes if 127 / amax is rounded twice (as ``1 / amax * 127``): the
    cases where an order of operations other than the reference's shows."""
    rng = np.random.default_rng(seed)
    f, out = np.float32, []
    while len(out) < n:
        a = f(rng.uniform(0.5, 4.0))
        once, twice = f(127.0) / a, (f(1.0) / a) * f(127.0)
        v = f((rng.integers(1, 126) + 0.5) / once)
        for _ in range(4):
            if np.round(v * once) != np.round(v * twice):
                out.append((a, v))
                break
            v = np.nextafter(v, f(np.inf))
    return out


def test_levels_at_rounding_ties_match_jax():
    """Each token holds its head's amax and a value at a rounding tie of
    its level: both write paths must land on the JAX levels there too."""
    bs, d = 4, 2
    pairs = _near_ties(16)
    vals = np.asarray([[[a, v]] for a, v in pairs], np.float32)  # [T, 1, 2]
    t = len(pairs)
    # one token per block, so each block's scale is its token's amax
    blocks = np.arange(1, t + 1, dtype=np.int32)
    offs = np.zeros(t, np.int32)
    pool = np.zeros((t + 1, bs, 1, d), np.int8)
    scales = np.zeros((t + 1, 1), np.float32)
    j_pool, j_sc = jq.quantize_scatter(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(vals),
        jnp.asarray(blocks), jnp.asarray(offs), jnp.asarray(blocks),
        jnp.int32(t))
    t_pool, t_sc = _t(pool.copy()), _t(scales.copy())
    tq.quantize_scatter(t_pool, t_sc, _t(vals), _t(blocks), _t(offs),
                        _t(blocks), t)
    np.testing.assert_array_equal(t_pool.numpy(), np.asarray(j_pool))
    j_pool, j_sc = jq.quantize_block_write(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(vals),
        jnp.asarray(blocks), jnp.asarray(offs))
    t_pool, t_sc = _t(pool.copy()), _t(scales.copy())
    tq.quantize_block_write(t_pool, t_sc, _t(vals), _t(blocks), _t(offs))
    np.testing.assert_array_equal(t_pool.numpy(), np.asarray(j_pool))


@pytest.mark.parametrize("seed", [4, 7])
def test_quantize_block_write_levels_match_jax(seed):
    """Slots append token after token into their blocks; an inactive slot
    writes into null block 0 each step. Every step's levels and scales
    must equal the JAX function's outside the null block (whose duplicate
    writes land in an unspecified order on either side)."""
    rng = np.random.default_rng(seed)
    bs, h, d, nb = 8, 2, 4, 6
    pool = np.zeros((nb, bs, h, d), np.int8)
    scales = np.zeros((nb, h), np.float32)
    j_pool, j_sc = jnp.asarray(pool), jnp.asarray(scales)
    t_pool, t_sc = _t(pool), _t(scales)
    blocks = np.asarray([1, 3, 0, 0], np.int32)     # slots 2, 3 inactive
    for i in range(bs):
        vec = (rng.standard_normal((4, h, d)) * (i + 1)
               * rng.uniform(0.5, 2.0, (4, 1, 1))).astype(np.float32)
        offs = np.asarray([i, i, 0, 0], np.int32)
        j_pool, j_sc = jq.quantize_block_write(
            j_pool, j_sc, jnp.asarray(vec), jnp.asarray(blocks),
            jnp.asarray(offs))
        tq.quantize_block_write(t_pool, t_sc, _t(vec), _t(blocks), _t(offs))
        np.testing.assert_array_equal(t_pool.numpy()[1:],
                                      np.asarray(j_pool)[1:], err_msg=str(i))
        np.testing.assert_allclose(t_sc.numpy()[1:], np.asarray(j_sc)[1:],
                                   rtol=SCALE_RTOL, atol=0)


def test_scatter_prefill_int8_leg_matches_jax():
    """The engine's prefill write (every layer, k and v) against the JAX
    `scatter_prefill` with scales."""
    from paddle_tpu.serving.cache import scatter_prefill as j_scatter
    rng = np.random.default_rng(8)
    layers, nb, bs, h, d, t, length = 2, 7, 4, 2, 8, 16, 11
    kl = rng.standard_normal((layers, t, h, d)).astype(np.float32) * 3
    vl = rng.standard_normal((layers, t, h, d)).astype(np.float32)
    row = np.asarray([2, 5, 3, 0, 0], np.int32)
    kp = np.zeros((layers, nb, bs, h, d), np.int8)
    ks = np.full((layers, nb, h), 0.5, np.float32)
    jk, jv, jks, jvs = j_scatter(jnp.asarray(kp), jnp.asarray(kp),
                                 jnp.asarray(kl), jnp.asarray(vl),
                                 jnp.asarray(row), jnp.int32(length), bs,
                                 jnp.asarray(ks), jnp.asarray(ks))
    tk, tv, tks, tvs = _t(kp.copy()), _t(kp.copy()), _t(ks.copy()), \
        _t(ks.copy())
    scatter_prefill(tk, tv, list(_t(kl)), list(_t(vl)), _t(row), length, bs,
                    k_scales=tks, v_scales=tvs)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in ((tks, jks), (tvs, jvs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SCALE_RTOL, atol=0)


def test_int8_cache_layout():
    cache = PagedKVCache(2, 3, 8, 5, 4, dtype=torch.int8)
    assert cache.quantized and cache.k_pools.dtype == torch.int8
    assert tuple(cache.k_scales.shape) == (2, 5, 3)
    assert cache.k_scales.dtype == torch.float32
    assert PagedKVCache(2, 3, 8, 5, 4, dtype="int8").dtype == torch.int8
    fp = PagedKVCache(2, 3, 8, 5, 4)
    assert fp.k_scales is None and not fp.quantized
    with pytest.raises(ValueError):
        PagedKVCache(2, 3, 8, 5, 4, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the int8 twin vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _quant_state(s=4, h=3, d=16, bs=4, m=6, lens=(0, 4, 8, 23), seed=0):
    """Random int8 pools with per-block-per-head scales, per-slot
    dense-prefix tables over disjoint blocks."""
    rng = np.random.default_rng(seed)
    nb = s * m + 1
    q = rng.standard_normal((s, h, d)).astype(np.float32)
    kp = rng.integers(-127, 128, (nb, bs, h, d)).astype(np.int8)
    vp = rng.integers(-127, 128, (nb, bs, h, d)).astype(np.int8)
    ks = rng.uniform(0.1, 4.0, (nb, h)).astype(np.float32)
    vs = rng.uniform(0.1, 4.0, (nb, h)).astype(np.float32)
    tables = np.stack([1 + i * m + np.arange(m) for i in range(s)]) \
        .astype(np.int32)
    return q, kp, vp, tables, np.asarray(lens, np.int32), ks, vs


@pytest.mark.parametrize("case", [
    dict(),
    dict(s=2, m=6, lens=(8, 7), seed=8),            # at a block boundary
    dict(s=3, h=2, d=64, bs=16, m=40, lens=(639, 300, 17), seed=4),
])
def test_int8_twin_matches_pallas_interpret(case):
    q, kp, vp, tables, lens, ks, vs = _quant_state(**case)
    bs = case.get("bs", 4)
    want = np.asarray(pallas_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lens), bs, jnp.asarray(ks), jnp.asarray(vs),
        interpret=True))
    args = [_t(a) for a in (q, kp, vp, tables, lens)]
    got = paged_attention(*args, bs, _t(ks), _t(vs))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dense = _dense_gather_attention(*args, bs, _t(ks), _t(vs))
    np.testing.assert_allclose(dense.numpy(), want, **TOL)
    chunked = paged_decode_reference(*args, bs, _t(ks), _t(vs),
                                     chunk_blocks=3)
    np.testing.assert_allclose(chunked.numpy(), want, **TOL)


def test_twin_refuses_mismatched_scales():
    q, kp, vp, tables, lens, ks, vs = _quant_state()
    args = [_t(a) for a in (q, kp, vp, tables, lens)]
    with pytest.raises(ValueError):
        paged_attention(*args, 4, _t(ks), None)
    with pytest.raises(ValueError):
        paged_attention(*args, 4, _t(ks[:, :1]), _t(vs[:, :1]))
    with pytest.raises(TypeError):
        paged_attention(args[0], args[0].new_zeros(kp.shape),
                        args[0].new_zeros(vp.shape), *args[3:], 4, _t(ks),
                        _t(vs))


@pytest.mark.parametrize("variant", ["pallas", "reference"])
def test_int8_decode_step_matches_jax(variant):
    """One decode step with int8 pools: the write (block requantization)
    and the attention, against the JAX function; an inactive slot with a
    null table writes into block 0 only."""
    rng = np.random.default_rng(11)
    s, h, d, bs, m = 3, 2, 16, 4, 5
    q, kp, vp, tables, _, ks, vs = _quant_state(s=s, h=h, d=d, bs=bs, m=m,
                                                seed=12)
    tables[1] = 0
    lens = np.asarray([9, 0, 12], np.int32)
    active = np.asarray([True, False, True])
    kn, vn = (rng.standard_normal((s, 1, h, d)).astype(np.float32)
              for _ in range(2))
    q4 = q[:, None]
    j_out, j_k, j_v, j_ks, j_vs = j_paged(
        *(jnp.asarray(a) for a in (q4, kn, vn, kp, vp, tables, lens, active)),
        bs, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        kernel=variant, interpret=variant == "pallas")
    t_k, t_v, t_ks, t_vs = (_t(a.copy()) for a in (kp, vp, ks, vs))
    out = t_paged(_t(q4), _t(kn), _t(vn), t_k, t_v, _t(tables), _t(lens),
                  _t(active), bs, k_scales=t_ks, v_scales=t_vs)
    assert len(out) == 5 and out[1] is t_k and out[3] is t_ks
    np.testing.assert_allclose(out[0].numpy()[active],
                               np.asarray(j_out)[active], **TOL)
    for got, want in ((t_k, j_k), (t_v, j_v)):
        np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])
    for got, want in ((t_ks, j_ks), (t_vs, j_vs)):
        np.testing.assert_allclose(got.numpy()[1:], np.asarray(want)[1:],
                                   rtol=SCALE_RTOL, atol=0)


# ---------------------------------------------------------------------------
# the kernel's split-K arithmetic with int8 pools (test_torch_paged_attention
# `split_emulation`: a partial per split, merged in split order) against the
# JAX decode step
# ---------------------------------------------------------------------------

# fp32: the emulation dequantizes the same levels under the same scales as
# the Pallas kernel and the blockwise reference (k * (scale * (1/127))) and
# sums the same fp32 terms in another order only
SPLIT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["pallas", "blockwise"])
@pytest.mark.parametrize("seq_lens, active", [
    ((47, 48, 49), (True, True, True)),      # spans of 1 entry, then 2
    ((511, 639, 40), (True, True, True)),    # all M blocks (3 x 14 entries)
    ((300, 0, 512), (True, False, True)),    # an inactive slot, null table
])
def test_int8_split_emulation_matches_jax(variant, seq_lens, active):
    """int8 pools at the serving head dim (D = 64, bs 16): 3 splits of at
    most 16 table entries in M = 40, sharing each slot's positions evenly.
    One JAX decode step (the int8 block write, then attention); the
    emulation runs on the pools and scales after that write."""
    from test_torch_paged_attention import split_emulation
    from paddle_tpu_torch.kernels.paged_attention import split_plan
    s, h, d, bs, m = 3, 2, 64, 16, 40
    assert split_plan(m, bs) == (16, 3)
    rng = np.random.default_rng(sum(seq_lens))
    q, kp, vp, tables, _, ks, vs = _quant_state(s=s, h=h, d=d, bs=bs, m=m,
                                                seed=sum(seq_lens) + 1)
    active = np.asarray(active)
    tables[~active] = 0
    lens = np.asarray(seq_lens, np.int32)
    kn, vn = (rng.standard_normal((s, 1, h, d)).astype(np.float32)
              for _ in range(2))
    j_out, j_k, j_v, j_ks, j_vs = j_paged(
        *(jnp.asarray(a) for a in (q[:, None], kn, vn, kp, vp, tables, lens,
                                   active)),
        bs, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        kernel=variant, interpret=variant == "pallas")
    emu = split_emulation(_t(q), *(_t(np.array(a)) for a in (j_k, j_v)),
                          _t(tables), _t(np.where(active, lens, 0)), bs,
                          *(_t(np.array(a)) for a in (j_ks, j_vs)))
    assert np.isfinite(emu.numpy()).all()
    np.testing.assert_allclose(emu.numpy()[active],
                               np.asarray(j_out)[active][:, 0], **SPLIT_TOL)


# ---------------------------------------------------------------------------
# the int8 engine vs the JAX int8 engine
# ---------------------------------------------------------------------------

VOCAB = 128
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPTForCausalLM(JGPTConfig(**CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    return jm, tm


def _prompt(length, seed=0):
    rng = np.random.default_rng(seed * 1000 + length)
    return rng.integers(0, VOCAB, length).tolist()


CASES = {
    "mixed_lengths": dict(lens=(11, 5, 17, 3), seed=21,
                          kw=dict(max_batch_size=4, block_size=4)),
    # a tight pool: eviction -> requeue -> re-prefill requantizes
    "churn": dict(lens=(11, 12, 10, 5), seed=22,
                  kw=dict(max_batch_size=3, block_size=4, num_blocks=10,
                          watermark_blocks=1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kv_dtype", ["int8", torch.int8])
def test_int8_engine_matches_jax_int8_engine(models, case, kv_dtype):
    jm, tm = models
    c = CASES[case]
    prompts = [_prompt(n, seed=c["seed"]) for n in c["lens"]]
    j_outs = JLLMEngine(jm, kv_dtype="int8", **c["kw"]).generate(
        prompts, max_new_tokens=10)
    engine = LLMEngine(tm, device="cpu", kv_dtype=kv_dtype, **c["kw"])
    outs = engine.generate(prompts, max_new_tokens=10)
    assert outs == j_outs
    st = engine.stats()
    assert st["kv_dtype"] == "int8" and st["completed"] == len(prompts)
    assert engine.cache.k_pools.dtype == torch.int8
    assert float(engine.cache.k_scales.abs().sum()) > 0
    if case == "churn":
        assert st["evictions"] >= 1


def test_int8_admits_1p8x_streams_at_same_pool_bytes(models):
    """The capacity win (mirrors tests/test_kernel_tier.py): with the same
    byte budget the int8 pool admits >= 1.8x the fp32 pool's streams
    (admission is host-side block accounting)."""
    tm = models[1]
    cfg = tm.config
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    budget = 96 * 1024

    def admitted(kv_dtype, dt):
        nb = num_blocks_for_bytes(budget, cfg.num_hidden_layers,
                                  cfg.num_attention_heads, head_dim, 4, dt)
        eng = LLMEngine(tm, max_batch_size=96, block_size=4, num_blocks=nb,
                        watermark_blocks=1, kv_dtype=kv_dtype, device="cpu")
        for i in range(96):
            eng.add_request(_prompt(8, seed=30 + i), max_new_tokens=8)
        n = 0
        while eng.scheduler.try_admit() is not None:
            n += 1
        return n

    n_fp32 = admitted(None, torch.float32)
    n_int8 = admitted("int8", torch.int8)
    assert n_int8 >= 1.8 * n_fp32, (n_int8, n_fp32)
