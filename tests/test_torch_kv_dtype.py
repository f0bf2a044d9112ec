"""Port parity: KV pools of the other float type than the model's.

`LLMEngine(model, kv_dtype=...)` with fp32 and bf16 pools under a model of
the other type. The reference casts every write to the pools' type
(`paddle_tpu/nn/functional/attention.py:268-271`, `serving/cache.py:279-281`
``.astype(pool.dtype)``) and reads the pools into fp32 scores; the port's
twins do the same, and its kernels take those pools on the card:

  * the decode write and the attention of one step, fp32 q over bf16 pools,
    against the JAX function: pools bit for bit (every block but null
    block 0, which only the twins write), outputs within fp32 summation
    order (1e-5);
  * the prompt scatter into pools of the other type, both ways, against
    the JAX `scatter_prefill`: bit for bit;
  * the kernel's split arithmetic (`split_emulation`) on bf16 pools under
    fp32 q against the JAX step;
  * an fp32 model with bf16 pools, end to end against the JAX engine with
    the same ``kv_dtype``: greedy and sampled streams equal, the pools
    after the prefills and decode steps bit for bit in layer 0 and within
    one bf16 step at a few elements of the deeper layers (their fp32 K/V
    differ from XLA's in the last bits before the cast), `stats()["kv_dtype"]`
    the reference's, and at equal pool bytes the bf16 pools admit twice
    the fp32 pools' blocks;
  * the kernel routes take mixed pools, float16 pools among them, up to
    the card check (meta tensors), and the engine builds and serves over
    float16 pools as the JAX engine does.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.nn.functional.attention import \
    paged_decode_attention as j_paged
from paddle_tpu.serving import LLMEngine as JLLMEngine
from paddle_tpu.serving.cache import scatter_prefill as j_scatter

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import prefill_scatter as ps
from paddle_tpu_torch.nn.functional import paged_decode_attention as t_paged
from paddle_tpu_torch.serving import (LLMEngine, num_blocks_for_bytes,
                                      pool_bytes_per_block)

from test_torch_paged_attention import split_emulation
from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 128
CFG = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=1, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0, initializer_range=0.3)
# fp32 outputs over the same fp32 values of the pools, summed in another
# order
TOL = dict(rtol=1e-5, atol=1e-5)

_J = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(_J[t.dtype])


def _pool_bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


# ---------------------------------------------------------------------------
# the decode write and attention, the prompt scatter
# ---------------------------------------------------------------------------

def _step_state(q_dtype, pool_dtype, seed, s=3, h=2, d=16, bs=4, m=5):
    g = torch.Generator().manual_seed(seed)
    nb = 1 + s * m
    pools = [torch.randn((nb, bs, h, d), generator=g).to(pool_dtype)
             for _ in range(2)]
    q, kn, vn = (torch.randn((s, 1, h, d), generator=g).to(q_dtype)
                 for _ in range(3))
    tables = torch.arange(1, 1 + s * m, dtype=torch.int32).view(s, m)
    tables[1] = 0
    lens = torch.tensor([9, 0, 12], dtype=torch.int32)
    active = torch.tensor([True, False, True])
    return q, kn, vn, pools, tables, lens, active, bs


@pytest.mark.parametrize("q_dtype, pool_dtype",
                         [(torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.float32)])
def test_decode_step_over_pools_of_the_other_type_matches_jax(q_dtype,
                                                              pool_dtype):
    q, kn, vn, (kp, vp), tables, lens, active, bs = _step_state(
        q_dtype, pool_dtype, seed=3)
    j_out, j_k, j_v = j_paged(*(_jnp(t) for t in (q, kn, vn, kp, vp)),
                              *(jnp.asarray(t.numpy()) for t in
                                (tables, lens, active)),
                              bs, kernel="reference")
    t_k, t_v = kp.clone(), vp.clone()
    out, k_out, v_out = t_paged(q, kn, vn, t_k, t_v, tables, lens, active,
                                bs)
    assert out.dtype == q_dtype and k_out is t_k and t_k.dtype == pool_dtype
    for got, want in ((t_k, j_k), (t_v, j_v)):
        want = torch.from_numpy(np.array(want.astype(jnp.float32))) \
            .to(pool_dtype)
        assert torch.equal(_pool_bits(got)[1:], _pool_bits(want)[1:])
    rows = active.numpy()
    np.testing.assert_allclose(_np(out)[rows],
                               np.asarray(j_out.astype(jnp.float32))[rows],
                               **(TOL if q_dtype == torch.float32 else
                                  dict(rtol=1e-2, atol=1e-2)))


def test_kernel_split_arithmetic_over_bf16_pools_matches_jax():
    """`split_emulation` (the kernel's order of work) on bf16 pools under
    fp32 q, after the twin's write, against the JAX step's output."""
    q, kn, vn, (kp, vp), tables, lens, active, bs = _step_state(
        torch.float32, torch.bfloat16, seed=5)
    j_out, _, _ = j_paged(*(_jnp(t) for t in (q, kn, vn, kp, vp)),
                          *(jnp.asarray(t.numpy()) for t in
                            (tables, lens, active)),
                          bs, kernel="reference")
    t_k, t_v = kp.clone(), vp.clone()
    t_paged(q, kn, vn, t_k, t_v, tables, lens, active, bs)
    eff = torch.where(active, lens, 0)
    emu = split_emulation(q[:, 0], t_k, t_v, tables, eff, bs)
    rows = active.numpy()
    np.testing.assert_allclose(emu.numpy()[rows], np.asarray(j_out)[rows, 0],
                               **TOL)


@pytest.mark.parametrize("row_dtype, pool_dtype",
                         [(torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.float32)])
def test_prompt_scatter_casts_as_jax(row_dtype, pool_dtype):
    g = torch.Generator().manual_seed(7)
    layers, nb, bs, h, d, t, length = 2, 9, 4, 2, 8, 16, 11
    kv = [torch.randn((t, h, d), generator=g).to(row_dtype)
          for _ in range(2 * layers)]
    pools = [torch.randn((layers, nb, bs, h, d), generator=g).to(pool_dtype)
             for _ in range(2)]
    row = torch.tensor([3, 7, 1, 5], dtype=torch.int32)
    jk, jv = j_scatter(_jnp(pools[0]), _jnp(pools[1]),
                       jnp.stack([_jnp(x) for x in kv[:layers]]),
                       jnp.stack([_jnp(x) for x in kv[layers:]]),
                       jnp.asarray(row.numpy()), length, bs)
    tk, tv = pools[0].clone(), pools[1].clone()
    ps.prefill_scatter(tk, tv, kv[:layers], kv[layers:], row,
                       torch.tensor(length, dtype=torch.int32), bs)
    for got, want in ((tk, jk), (tv, jv)):
        want = torch.from_numpy(np.array(want.astype(jnp.float32))) \
            .to(pool_dtype)
        assert torch.equal(_pool_bits(got)[:, 1:], _pool_bits(want)[:, 1:])


# ---------------------------------------------------------------------------
# the kernel routes (meta tensors: checks without storage)
# ---------------------------------------------------------------------------

def _meta_append(q_dtype, pool_dtype):
    s, h, d, bs, m = 2, 2, 64, 4, 3
    qkv = torch.zeros((s, 3, h, d), dtype=q_dtype, device="meta")
    pool = torch.zeros((1 + s * m, bs, h, d), dtype=pool_dtype,
                       device="meta")
    return (qkv[:, 0], qkv[:, 1], qkv[:, 2], pool, pool.clone(),
            torch.zeros((s, m), dtype=torch.int32, device="meta"),
            torch.zeros(s, dtype=torch.int32, device="meta"),
            torch.zeros(s, dtype=torch.bool, device="meta"), bs)


@pytest.mark.parametrize("q_dtype, pool_dtype",
                         [(torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.float32)])
def test_fused_kernel_route_takes_pools_of_the_other_type(q_dtype,
                                                          pool_dtype):
    with pytest.raises(RuntimeError, match="expected a CUDA tensor"):
        pa.paged_decode_append(*_meta_append(q_dtype, pool_dtype))


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_kernel_routes_refuse_float16_pools(q_dtype):
    """float16 pools under fp32 or bf16 q (the case once refused) pass
    every check of the three kernel routes and reach the card check; the
    codes the C entries get name the pools' own type."""
    with pytest.raises(RuntimeError, match="expected a CUDA tensor"):
        pa.paged_decode_append(*_meta_append(q_dtype, torch.float16))
    q, _, _, pool, pool2, tables, lens, _, bs = _meta_append(q_dtype,
                                                             torch.float16)
    with pytest.raises(RuntimeError, match="expected a CUDA tensor"):
        pa.paged_attention(q.contiguous(), pool, pool2, tables, lens, bs)
    assert pa._pool_kind(q, pool, pool2, False) == 2
    assert pa.append_name(q_dtype, torch.float16) == \
        "paged_decode_append_to_fp16"
    layers = [torch.zeros((8, 2, 64), dtype=q_dtype, device="meta")] * 2
    pools = torch.zeros((2, 7, 4, 2, 64), dtype=torch.float16,
                        device="meta")
    with pytest.raises(RuntimeError, match="expected a CUDA tensor"):
        ps.prefill_scatter(pools, pools.clone(), layers, layers,
                           torch.zeros(2, dtype=torch.int32, device="meta"),
                           torch.zeros((), dtype=torch.int32, device="meta"),
                           4)
    assert ps._dtype_code(pools, layers) == \
        3 + 3 * 2 + (0 if q_dtype == torch.float32 else 1)
    assert ps.scatter_name(q_dtype, torch.float16) == \
        "prefill_scatter_to_fp16"


@pytest.mark.parametrize("row_dtype, pool_dtype",
                         [(torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.float32)])
def test_scatter_kernel_route_takes_pools_of_the_other_type(row_dtype,
                                                            pool_dtype):
    qkv = torch.zeros((8, 3, 2, 64), dtype=row_dtype, device="meta")
    layers = [qkv[:, 1]] * 2
    pools = torch.zeros((2, 7, 4, 2, 64), dtype=pool_dtype, device="meta")
    with pytest.raises(RuntimeError, match="expected a CUDA tensor"):
        ps.prefill_scatter(pools, pools.clone(), layers, layers,
                           torch.zeros(2, dtype=torch.int32, device="meta"),
                           torch.zeros((), dtype=torch.int32, device="meta"),
                           4)
    # 3 + 3 x the pools' code + the rows' code (kernels/_dtype.py)
    assert ps._dtype_code(pools, layers) == \
        (6 if row_dtype == torch.float32 else 4)


# ---------------------------------------------------------------------------
# the engine against the JAX engine with the same kv_dtype
# ---------------------------------------------------------------------------

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


ENGINE = dict(max_batch_size=2, block_size=4)


def test_engine_greedy_streams_and_pools_equal_the_jax_engine(models):
    """fp32 model, bf16 pools: the streams and, after every request has
    run its prefill and some decode steps, the pools bit for bit."""
    jm, tm = models
    prompts = [_prompt(n, seed=2) for n in (9, 6, 11)]
    je = JLLMEngine(jm, kv_dtype=jnp.bfloat16, **ENGINE)
    te = LLMEngine(tm, device="cpu", kv_dtype=torch.bfloat16, **ENGINE)
    jr = [je.add_request(p, max_new_tokens=7) for p in prompts]
    tr = [te.add_request(p, max_new_tokens=7) for p in prompts]
    for _ in range(4):
        je.step()
        te.step()
    assert te.cache.k_pools.dtype == torch.bfloat16
    for got, want in ((te.cache.k_pools, je._k_pools),
                      (te.cache.v_pools, je._v_pools)):
        want = torch.from_numpy(np.array(want.astype(jnp.float32))) \
            .to(torch.bfloat16)
        got, want = got[:, 1:], want[:, 1:]
        # layer 0's K/V come from the embeddings through one projection,
        # whose fp32 sums round to the same bf16 values: bit for bit
        assert torch.equal(_pool_bits(got[0]), _pool_bits(want[0]))
        # deeper layers' fp32 K/V differ from XLA's in the last fp32 bits
        # (attention and MLP summed in another order, ~1e-6 at values of
        # O(1)), so a value next to a bf16 rounding step may round the
        # other way: one bf16 step of the value, or that absolute error
        # where cancellation left a small value, at a few elements in ten
        # thousand
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= 2.0 ** -7 * want.float().abs()
                     + 2.0 ** -16).all())
        assert int((diff > 0).sum()) <= got.numel() // 5000
    je.run()
    te.run()
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert te.stats()["kv_dtype"] == je.stats()["kv_dtype"] == "bfloat16"


def test_engine_sampled_streams_equal_the_jax_engine(models):
    jm, tm = models
    prompts = [_prompt(n, seed=3) for n in (8, 5, 10)]
    kw = [dict(temperature=0.8, top_k=6, seed=11),
          dict(temperature=1.1, top_p=0.8, seed=12),
          dict(temperature=0.7, repetition_penalty=1.3, seed=13)]
    je = JLLMEngine(jm, kv_dtype=jnp.bfloat16, **ENGINE)
    te = LLMEngine(tm, device="cpu", kv_dtype="bfloat16", **ENGINE)
    jr = [je.add_request(p, max_new_tokens=8, **k)
          for p, k in zip(prompts, kw)]
    tr = [te.add_request(p, max_new_tokens=8, **k)
          for p, k in zip(prompts, kw)]
    je.run()
    te.run()
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert te.stats()["sampled_tokens"] == 24


def test_pool_bytes_count_the_pools_own_type(models):
    """At one byte budget bf16 pools buy twice the fp32 pools' blocks
    (the reference's count), and an engine built on each admits a stream
    needing twice the blocks."""
    _, tm = models
    cfg = tm.config
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    dims = (cfg.num_hidden_layers, cfg.num_attention_heads, head_dim, 4)
    budget = 40 * pool_bytes_per_block(*dims, dtype=torch.float32)
    n32 = num_blocks_for_bytes(budget, *dims, dtype=torch.float32)
    n16 = num_blocks_for_bytes(budget, *dims, dtype=torch.bfloat16)
    assert (n32, n16) == (40, 80)
    for kv, n in ((torch.float32, n32), (torch.bfloat16, n16)):
        engine = LLMEngine(tm, device="cpu", kv_dtype=kv, num_blocks=n,
                           max_batch_size=2, block_size=4)
        assert engine.cache.k_pools.dtype == kv
        assert engine.cache.allocator.capacity == n - 1


def test_float16_pools_are_refused(models):
    """An fp32 model over float16 pools (the case once refused): the
    engine builds, counts 2 bytes a pooled value, and serves the JAX
    engine's greedy streams with kv_dtype float16."""
    jm, tm = models
    prompts = [_prompt(n, seed=4) for n in (9, 6, 11)]
    je = JLLMEngine(jm, kv_dtype=jnp.float16, **ENGINE)
    te = LLMEngine(tm, device="cpu", kv_dtype=torch.float16, **ENGINE)
    assert te.cache.k_pools.dtype == torch.float16
    cfg = tm.config
    dims = (cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.hidden_size // cfg.num_attention_heads, 4)
    assert pool_bytes_per_block(*dims, dtype=torch.float16) == \
        pool_bytes_per_block(*dims, dtype=torch.bfloat16)
    jr = [je.add_request(p, max_new_tokens=7) for p in prompts]
    tr = [te.add_request(p, max_new_tokens=7) for p in prompts]
    je.run()
    te.run()
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert te.stats()["kv_dtype"] == je.stats()["kv_dtype"] == "float16"
