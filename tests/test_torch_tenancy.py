"""Port parity: paddle_tpu_torch's multi-tenant serving vs the JAX package's.

  * `PrefixCache`: the port's copy and the reference's, each over its own
    package's `BlockAllocator`, driven through the same operation
    sequences (publish, acquire, partial-block match, reclaim order: leaf
    first, popularity, recency, aging; invalidate, reset; and seeded random
    sequences) give the same hits, refcounts, free counts and dropped
    entries;
  * engine streams with the prefix cache on, fp32 and int8 pools, the port
    unpipelined and pipelined, against the JAX engine (unpipelined): shared
    prompts (one prefill), identical prompts (hit = len - 1, copy-on-write
    inside a shared block), pool pressure (index entries reclaimed) and
    sampled prefix-hit streams with a repetition penalty. Tokens exact;
    logprobs within 1e-6 with fp32 pools (the same path in both packages:
    a hit's suffix runs through the paged decode step in each), within
    1e-4 with int8 pools (tests/test_torch_serving_prefill.py's bound);
    the counters `prefills`, `prefix_hit_tokens`, `cow_copies` and
    `prefix_evictions` equal the JAX engine's;
  * adapters registered from the same seeds in both packages: streams
    equal the JAX engine's (prefix cache off); prefix blocks are indexed per
    adapter, so with the cache on every tenant's stream equals the cache-off
    one (the reference's token-only index changes adapter tenants'
    streams); base tenants bit for bit with the adapter-free port engine,
    churn keeps `decode_compiles` at 1 and `prefill_compiles` at the
    bucket count, the stacks keep their storage;
    `adapter_mismatch`, the unregister-while-live refusal, registry
    validation and `merged` restoring the weights bit for bit;
  * hot-swap, between steps and mid-run at the boundary, against the JAX
    engine swapped to the same weights (`convert.jax_state_values`):
    staging identical weights is a no-op, a swap empties the prefix index,
    the parameters keep their storage and `decode_compiles` stays 1.

The model is tests/test_tenancy.py's tiny GPT (vocab 128, hidden 32, two
layers, four heads of 8, block size 4); its weights are carried into the
port by `convert.load_jax_state`.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import BlockAllocator as JBlockAllocator
from paddle_tpu.serving import LLMEngine as JLLMEngine
from paddle_tpu.serving import PrefixCache as JPrefixCache
from paddle_tpu.serving.tenancy import _AGE_PERIOD as J_AGE_PERIOD

from paddle_tpu_torch.convert import jax_state_values, load_jax_state
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (AdapterSet, BlockAllocator, FINISHED,
                                      LLMEngine, PrefixCache, ServeRefusal)
from paddle_tpu_torch.serving.tenancy import _AGE_PERIOD

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 128
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)


def _pair(seed):
    """The reference's tiny GPT from `seed` and the port's copy of it."""
    paddle.seed(seed)
    jm = JGPTForCausalLM(JGPTConfig(use_flash_attention=False, **CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_jax_state(tm, _named(jm))
    return jm, tm


def _named(jm):
    return {n: np.asarray(p._value) for n, p in jm.named_parameters()}


@pytest.fixture(scope="module")
def models():
    return _pair(0)


def _prompt(length, seed=0):
    rng = np.random.default_rng(seed * 1000 + length)
    return rng.integers(0, VOCAB, length).tolist()


def _shared_prompts(n_prompts, prefix_len=12, suffix_len=3, seed=7):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, VOCAB, prefix_len).tolist()
    return [prefix + rng.integers(0, VOCAB, suffix_len).tolist()
            for _ in range(n_prompts)]


# ---------------------------------------------------------------------------
# PrefixCache: the port's copy against the reference's
# ---------------------------------------------------------------------------

def _state(pc, alloc):
    return (pc.entries, alloc.num_free, alloc.num_shared, pc.hits,
            pc.misses, sorted(alloc._refs.items()))


def _roundtrip(pc, alloc):
    toks = list(range(10))                       # 2 full blocks + tail 2
    blocks = alloc.allocate(3)
    out = [pc.publish(toks, blocks), pc.probe(toks), pc.acquire(toks),
           _state(pc, alloc)]
    alloc.free(out[2][0])
    return out + [_state(pc, alloc)]


def _partial(pc, alloc):
    toks = list(range(12))
    pc.publish(toks, alloc.allocate(3))
    got = pc.acquire(toks[:6] + [99, 98, 97, 96])
    return [got, pc.acquire(toks[:2] + [99] * 8), pc.acquire(toks[:3]),
            pc.probe(toks + [5]), _state(pc, alloc)]


def _leaf_first(pc, alloc):
    out = []
    for toks, n in ((list(range(8)), 2), ([50, 51, 52, 53], 1)):
        blocks = alloc.allocate(n)
        out.append(pc.publish(toks, blocks))
        alloc.free(blocks)
    got, hit = pc.acquire(list(range(8)) + [99])
    alloc.free(got)
    out += [hit, pc.reclaim(5), _state(pc, alloc),
            pc.acquire([50, 51, 52, 53, 99]), pc.reclaim(6),
            pc.probe(list(range(8)) + [99]), _state(pc, alloc)]
    return out


def _popularity(pc, alloc):
    hot, cold = [10, 11, 12, 13], [20, 21, 22, 23]
    for toks in (hot, cold):
        blocks = alloc.allocate(1)
        pc.publish(toks, blocks)
        alloc.free(blocks)
    for toks in (hot, hot, hot, cold):
        got, _ = pc.acquire(toks + [99])
        alloc.free(got)
    out = [pc.reclaim(alloc.num_free + 1), pc.probe(cold + [99]),
           pc.probe(hot + [99])]
    # recency breaks a tie of hit counts
    first, second = [30, 31, 32, 33], [40, 41, 42, 43]
    for toks in (first, second):
        blocks = alloc.allocate(1)
        pc.publish(toks, blocks)
        alloc.free(blocks)
    for toks in (first, second):
        got, _ = pc.acquire(toks + [99])
        alloc.free(got)
    return out + [pc.reclaim(alloc.num_free + 1), pc.probe(first + [99]),
                  pc.probe(second + [99]), _state(pc, alloc)]


def _aging(pc, alloc):
    stale = [10, 11, 12, 13]
    blocks = alloc.allocate(1)
    pc.publish(stale, blocks)
    alloc.free(blocks)
    for _ in range(4):
        got, _ = pc.acquire(stale + [99])
        alloc.free(got)
    for i in range(2 * _AGE_PERIOD):
        pc.acquire([70 + (i % 8), 1, 2, 3, 4])
    fresh = [20, 21, 22, 23]
    blocks = alloc.allocate(1)
    pc.publish(fresh, blocks)
    alloc.free(blocks)
    got, _ = pc.acquire(fresh + [99])
    alloc.free(got)
    return [pc.reclaim(alloc.num_free + 1), pc.probe(stale + [99]),
            pc.probe(fresh + [99]), _state(pc, alloc)]


def _pinned_interior(pc, alloc):
    chain = list(range(12))
    blocks = alloc.allocate(3)
    pc.publish(chain, blocks)
    alloc.free(blocks)
    out = [pc.reclaim(alloc.num_free + 1), pc.probe(chain + [99])]
    got, hit = pc.acquire(chain + [99])
    alloc.free(got)
    return out + [hit, _state(pc, alloc)]


def _invalidate_reset(pc, alloc, allocator):
    blocks = alloc.allocate(2)
    pc.publish(list(range(8)), blocks)
    alloc.free(blocks)
    out = [pc.invalidate(), _state(pc, alloc)]
    blocks = alloc.allocate(2)
    pc.publish(list(range(8)) + [1, 2], blocks, include_tail=False)
    out.append(_state(pc, alloc))
    pc.reset(allocator(16))
    return out + [pc.entries, [alloc.refcount(b) for b in blocks]]


def _random_ops(seed):
    def drive(pc, alloc):
        rng = np.random.default_rng(seed)
        stems = [rng.integers(0, 6, 11).tolist() for _ in range(3)]
        held, out = [], []
        for _ in range(120):
            op = rng.integers(0, 5)
            stem = stems[rng.integers(0, 3)]
            toks = stem[:rng.integers(2, 12)] + rng.integers(
                0, 6, rng.integers(0, 4)).tolist()
            if op == 0:
                blocks = alloc.allocate(-(-len(toks) // 4))
                if blocks is not None:
                    out.append(pc.publish(
                        toks, blocks,
                        include_tail=bool(rng.integers(0, 2))))
                    held.append(blocks)
            elif op == 1:
                got = pc.acquire(toks)
                out.append(got)
                if got[0]:
                    held.append(got[0])
            elif op == 2 and held:
                alloc.free(held.pop(rng.integers(0, len(held))))
            elif op == 3:
                out.append(pc.reclaim(rng.integers(0, alloc.capacity + 1)))
            else:
                out.append(pc.probe(toks))
            out.append(_state(pc, alloc))
        return out
    return drive


PREFIX_SCENARIOS = {
    "roundtrip_len_minus_one": (16, _roundtrip),
    "partial_and_sub_block": (16, _partial),
    "reclaim_leaf_first": (8, _leaf_first),
    "reclaim_popularity_then_recency": (8, _popularity),
    "reclaim_aging": (8, _aging),
    "reclaim_pinned_interior": (8, _pinned_interior),
    "invalidate_reset": (16, None),
    **{f"random_{seed}": (12, _random_ops(seed)) for seed in range(4)},
}


@pytest.mark.parametrize("name", sorted(PREFIX_SCENARIOS))
def test_prefix_cache_matches_the_reference(name):
    assert _AGE_PERIOD == J_AGE_PERIOD
    num_blocks, fn = PREFIX_SCENARIOS[name]
    traces = []
    for cache_cls, alloc_cls in ((JPrefixCache, JBlockAllocator),
                                 (PrefixCache, BlockAllocator)):
        alloc = alloc_cls(num_blocks)
        pc = cache_cls(alloc, 4)
        if fn is None:
            traces.append(_invalidate_reset(pc, alloc, alloc_cls))
        else:
            traces.append(fn(pc, alloc))
    assert traces[0] == traces[1]


# ---------------------------------------------------------------------------
# prefix-cache serving against the JAX engine
# ---------------------------------------------------------------------------

SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9, repetition_penalty=1.3)


def _case_requests(case):
    """``(engine kwargs, [[(prompt, add_request kwargs)] per generate
    call], max_new_tokens)`` of each serving case."""
    if case == "shared_prompts":
        prompts = _shared_prompts(4, prefix_len=12, suffix_len=3)
        return dict(max_batch_size=4, num_blocks=64), \
            [[(p, {}) for p in prompts]], 8
    if case == "identical_prompts":
        p = _prompt(12, seed=11)
        return dict(max_batch_size=2, num_blocks=64), \
            [[(p, {}), (list(p), {})]], 8
    if case == "pool_pressure":
        return dict(max_batch_size=2, num_blocks=14), \
            [[(_prompt(12, seed=s), {})] for s in (21, 22, 23, 24, 25)], 6
    if case == "sampled_penalty":
        prompts = _shared_prompts(3, prefix_len=9, suffix_len=4, seed=17)
        cfgs = [dict(SAMPLED, seed=i) for i in range(3)]
        return dict(max_batch_size=3, num_blocks=64), \
            [list(zip(prompts, cfgs)), [(list(prompts[0]), cfgs[1])]], 10
    raise KeyError(case)


COUNTERS = ("prefills", "prefix_hit_tokens", "cow_copies",
            "prefix_evictions")
_JAX_STREAMS = {}


def _serve(engine, batches, new):
    out = []
    for batch in batches:
        reqs = [engine.add_request(p, max_new_tokens=new, **kw)
                for p, kw in batch]
        engine.run()
        out += [(list(r.generated), list(r.token_logprobs)) for r in reqs]
    return out, engine.stats()


def _jax_streams(jm, case, kv_dtype):
    key = (case, kv_dtype)
    if key not in _JAX_STREAMS:
        kw, batches, new = _case_requests(case)
        _JAX_STREAMS[key] = _serve(
            JLLMEngine(jm, block_size=4, kv_dtype=kv_dtype,
                       enable_prefix_cache=True, **kw), batches, new)
    return _JAX_STREAMS[key]


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("case", ["shared_prompts", "identical_prompts",
                                  "pool_pressure", "sampled_penalty"])
def test_prefix_streams_equal_the_jax_engine(models, case, kv_dtype,
                                             pipelined):
    jm, tm = models
    want, j_st = _jax_streams(jm, case, kv_dtype)
    kw, batches, new = _case_requests(case)
    engine = LLMEngine(tm, device="cpu", block_size=4, kv_dtype=kv_dtype,
                       enable_prefix_cache=True, pipeline_decode=pipelined,
                       **kw)
    got, st = _serve(engine, batches, new)
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose(
        np.array([lp for _, lps in got for lp in lps]),
        np.array([lp for _, lps in want for lp in lps]), rtol=0,
        atol=1e-4 if kv_dtype else 1e-6)
    assert {k: st[k] for k in COUNTERS} == {k: j_st[k] for k in COUNTERS}
    assert st["decode_compiles"] == 1
    assert st["prefix_hit_rate"] == pytest.approx(j_st["prefix_hit_rate"])
    if case == "pool_pressure":
        assert st["prefix_evictions"] > 0
    else:
        assert st["prefix_hit_tokens"] > 0 and st["cow_copies"] >= 1
        assert st["prefills"] < sum(len(b) for b in batches)
    if case == "identical_prompts":
        # the second stream aliases every block, the tail included
        assert st["prefix_hit_tokens"] == 11 and st["prefills"] == 1


def test_prefix_hit_writes_the_history_row_and_chews(models):
    """A prefix hit runs no prefill: its history row is ctx[:hit] and zeros
    (one copy at admission), and each chew step writes its input token at
    ``lens``; the stream emits nothing until the last context token's step,
    and its table starts with the publisher's blocks."""
    _, tm = models
    engine = LLMEngine(tm, device="cpu", max_batch_size=2, block_size=4,
                       num_blocks=64, enable_prefix_cache=True)
    first, second = _shared_prompts(2, prefix_len=12, suffix_len=3, seed=5)
    a = engine.add_request(first, max_new_tokens=6)
    engine.step()
    b = engine.add_request(second, max_new_tokens=6)
    engine.step()                         # b's admission and first chew
    assert b.prefix_hit == 12 and b.blocks[:3] == a.blocks[:3]
    assert engine.stats()["prefills"] == 1
    row = engine._history[b.slot].tolist()
    assert row[:13] == second[:13] and row[13:] == [0] * (len(row) - 13)
    assert b.chew == second[14:] and b.generated == []
    engine.step()                         # chews second[13]
    assert b.chew == [] and b.generated == []
    engine.step()                         # the last context token's step
    assert len(b.generated) == 1
    assert engine._history[b.slot].tolist()[:15] == second
    engine.run()
    assert a.state == b.state == FINISHED


@pytest.mark.parametrize("pipelined", [False, True])
def test_cancel_during_chew_rolls_back_cleanly(models, pipelined):
    """A stream cancelled while it chews frees its private blocks and its
    references on the shared ones; the index keeps its own, and the next
    sharer still hits."""
    _, tm = models
    engine = LLMEngine(tm, device="cpu", max_batch_size=2, block_size=4,
                       num_blocks=64, enable_prefix_cache=True,
                       pipeline_decode=pipelined)
    first, second, third = _shared_prompts(3, prefix_len=12, suffix_len=6,
                                           seed=6)
    engine.generate([first], max_new_tokens=2)
    b = engine.add_request(second, max_new_tokens=4)
    engine.step()
    assert b.chew
    engine.cancel(b.rid)
    alloc = engine.cache.allocator
    assert alloc.num_free == alloc.capacity - engine.stats()["prefix_entries"]
    out = engine.generate([third], max_new_tokens=4)[0]
    fresh = LLMEngine(tm, device="cpu", max_batch_size=2, block_size=4,
                      num_blocks=64)
    assert out == fresh.generate([third], max_new_tokens=4)[0]
    assert engine.stats()["prefix_hit_tokens"] == 2 * 12


def test_unrelated_prompts_all_miss(models):
    _, tm = models
    engine = LLMEngine(tm, device="cpu", max_batch_size=2, block_size=4,
                       num_blocks=64, enable_prefix_cache=True)
    prompts = [_prompt(9, seed=13), _prompt(10, seed=14)]
    outs = engine.generate(prompts, max_new_tokens=6)
    plain = LLMEngine(tm, device="cpu", max_batch_size=2, block_size=4,
                      num_blocks=64)
    assert outs == plain.generate(prompts, max_new_tokens=6)
    st = engine.stats()
    assert st["prefix_hit_tokens"] == 0 and st["prefills"] == 2
    assert st["prefix_entries"] > 0


# ---------------------------------------------------------------------------
# adapters
# ---------------------------------------------------------------------------

def _adapter_engine(model, package, **kw):
    kw = dict(dict(max_batch_size=3, block_size=4, num_blocks=64,
                   max_adapters=3, adapter_rank=2), **kw)
    if package == "jax":
        engine = JLLMEngine(model, **kw)
    else:
        engine = LLMEngine(model, device="cpu", **kw)
    engine.register_adapter("t1", seed=1, scale=25.0)
    engine.register_adapter("t2", seed=2, scale=25.0)
    return engine


TENANT_PLAN = ["t1", None, "t2", "t1", "t2", None]


def _tenant_streams(engine, prompts, plan, cfgs=None):
    cfgs = cfgs or [{}] * len(prompts)
    reqs = [engine.add_request(p, max_new_tokens=5, request_id=f"c{i}",
                               adapter=ad, **c)
            for i, (p, ad, c) in enumerate(zip(prompts, plan, cfgs))]
    engine.run()
    return [(list(r.generated), list(r.token_logprobs)) for r in reqs]


# 7 usable blocks for streams of up to 4: growth evicts the newest, which
# re-prefills under its adapter
POOLS = {"roomy": {}, "tight": dict(num_blocks=8, watermark_blocks=0)}


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_adapter_streams_equal_the_jax_engine(models, pool, pipelined):
    jm, tm = models
    prompts = _shared_prompts(6, prefix_len=8, suffix_len=2, seed=40)
    cfgs = [{}, {}, dict(SAMPLED, seed=3), {}, {}, dict(SAMPLED, seed=4)]
    want = _tenant_streams(_adapter_engine(jm, "jax", **POOLS[pool]),
                           prompts, TENANT_PLAN, cfgs)
    engine = _adapter_engine(tm, "torch", pipeline_decode=pipelined,
                             **POOLS[pool])
    got = _tenant_streams(engine, prompts, TENANT_PLAN, cfgs)
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose(
        np.array([lp for _, lps in got for lp in lps]),
        np.array([lp for _, lps in want for lp in lps]), rtol=0, atol=1e-5)
    st = engine.stats()
    assert st["decode_compiles"] == 1 and st["adapter_switches"] >= 2
    assert sorted(st["adapters"]) == ["t1", "t2"]
    assert (st["evictions"] > 0) == (pool == "tight")


@pytest.mark.parametrize("pipelined", [False, True])
def test_prefix_hits_stay_within_an_adapter(models, pipelined):
    """A prompt's K and V depend on the adapter its qkv projection ran
    under, so the port indexes prefix blocks per adapter: with the prefix
    cache on, every tenant's stream equals the same engine's with it off
    (tokens; logprobs within 1e-5), and only same-tenant prompts hit. The
    reference indexes by tokens alone: there the cache changes an adapter
    tenant's stream."""
    jm, tm = models
    prompts = _shared_prompts(6, prefix_len=8, suffix_len=2, seed=40)
    cold = _tenant_streams(_adapter_engine(tm, "torch"), prompts,
                           TENANT_PLAN)
    engine = _adapter_engine(tm, "torch", enable_prefix_cache=True,
                             pipeline_decode=pipelined)
    got = _tenant_streams(engine, prompts, TENANT_PLAN)
    assert [t for t, _ in got] == [t for t, _ in cold]
    np.testing.assert_allclose(
        np.array([lp for _, lps in got for lp in lps]),
        np.array([lp for _, lps in cold for lp in lps]), rtol=0, atol=1e-5)
    st = engine.stats()
    # one prefill a tenant (t1, base, t2), the later same-tenant prompts
    # hit the 8-token shared prefix
    assert st["prefills"] == 3 and st["prefix_hit_tokens"] == 3 * 8
    j_cold = _tenant_streams(_adapter_engine(jm, "jax"), prompts,
                             TENANT_PLAN)
    j_hot = _tenant_streams(_adapter_engine(jm, "jax",
                                            enable_prefix_cache=True),
                            prompts, TENANT_PLAN)
    assert [t for t, _ in j_cold] == [t for t, _ in cold]
    assert [t for t, _ in j_hot] != [t for t, _ in j_cold]


def test_unregister_drops_the_adapters_prefix_entries(models):
    _, tm = models
    engine = _adapter_engine(tm, "torch", enable_prefix_cache=True)
    prompts = _shared_prompts(3, prefix_len=8, suffix_len=2, seed=43)
    _tenant_streams(engine, prompts, ["t2", None, "t2"])
    held = engine.stats()["prefix_entries"]
    assert engine.stats()["prefix_hit_tokens"] == 8
    engine.unregister_adapter("t2")
    assert 0 < engine.stats()["prefix_entries"] < held
    engine.register_adapter("t2", seed=7, scale=25.0)
    engine.reset_stats()
    req = engine.add_request(prompts[0], max_new_tokens=5, adapter="t2")
    engine.run()
    st = engine.stats()
    assert st["prefills"] == 1 and st["prefix_hit_tokens"] == 0
    other = _adapter_engine(tm, "torch")
    other.unregister_adapter("t2")
    other.register_adapter("t2", seed=7, scale=25.0)
    want = other.add_request(prompts[0], max_new_tokens=5, adapter="t2")
    other.run()
    assert req.generated == want.generated


def test_prefix_namespaces_are_separate():
    alloc = BlockAllocator(16)
    pc = PrefixCache(alloc, 4)
    toks = list(range(10))
    pc.publish(toks, alloc.allocate(3), namespace="a")
    assert pc.acquire(toks) == ([], 0)
    assert pc.probe(toks, namespace="b") == (0, 0)
    got, hit = pc.acquire(toks, namespace="a")
    assert hit == 9
    alloc.free(got)
    pc.publish(toks, alloc.allocate(3))
    assert pc.entries == 6
    assert pc.invalidate("a") == 3 and pc.entries == 3
    assert pc.acquire(toks, namespace="a") == ([], 0)
    assert pc.acquire(toks)[1] == 9


def test_base_tenant_bit_identical_to_the_adapter_free_engine(models):
    _, tm = models
    prompts = _shared_prompts(6, prefix_len=8, suffix_len=2, seed=41)
    plan = ["t1", None, "t2", None, "t1", None]
    engine = _adapter_engine(tm, "torch")
    got = _tenant_streams(engine, prompts, plan)
    plain = LLMEngine(tm, device="cpu", max_batch_size=3, block_size=4,
                      num_blocks=64)
    want = _tenant_streams(plain, prompts, [None] * 6)
    for i, ad in enumerate(plan):
        if ad is None:
            assert got[i] == want[i]           # tokens and logprobs
        else:
            assert got[i][0] != want[i][0]     # the delta bites


def test_adapter_churn_builds_nothing(models):
    """Tenants joining and leaving write values into the stacks, the slot
    buffer and the prefill buffer: one decode build, one prefill build a
    bucket, the stacks' storage kept, and a re-registered slot serves the
    new adapter at once."""
    _, tm = models
    engine = _adapter_engine(tm, "torch")
    stacks = engine._adapters
    ptrs = [t.data_ptr() for t in (*stacks.a.values(), *stacks.b.values(),
                                   stacks.scale)]
    prompts = _shared_prompts(6, prefix_len=8, suffix_len=2, seed=42)
    first = _tenant_streams(engine, prompts, TENANT_PLAN)
    engine.unregister_adapter("t2")
    engine.register_adapter("t3", seed=9, scale=25.0)
    engine.add_request(prompts[0], max_new_tokens=5, request_id="c9",
                       adapter="t3")
    engine.run()
    c9 = engine.pop_finished()["c9"]
    assert c9.state == FINISHED
    st = engine.stats()
    assert st["decode_compiles"] == 1
    assert st["prefill_compiles"] == len(engine._prefill_fns) == 1
    assert [t.data_ptr() for t in (*stacks.a.values(), *stacks.b.values(),
                                   stacks.scale)] == ptrs
    # t3 took t2's slot: a fresh engine with t3 alone gives its stream
    other = LLMEngine(tm, device="cpu", max_batch_size=3, block_size=4,
                      num_blocks=64, max_adapters=3, adapter_rank=2)
    other.register_adapter("t3", seed=9, scale=25.0)
    req = other.add_request(prompts[0], max_new_tokens=5, adapter="t3")
    other.run()
    assert c9.generated == req.generated != first[0][0]


def test_unknown_adapter_refused_as_adapter_mismatch(models):
    _, tm = models
    engine = LLMEngine(tm, device="cpu", max_batch_size=2, block_size=4,
                       num_blocks=64, max_adapters=2)
    with pytest.raises(ServeRefusal) as ei:
        engine.add_request(_prompt(5, seed=34), max_new_tokens=4,
                           adapter="nobody")
    assert ei.value.reason == "adapter_mismatch"
    assert engine.stats()["refused"] == 1


def test_unregister_refuses_while_streams_live(models):
    _, tm = models
    engine = LLMEngine(tm, device="cpu", max_batch_size=2, block_size=4,
                       num_blocks=64, max_adapters=2)
    engine.register_adapter("busy", seed=5)
    engine.add_request(_prompt(6, seed=35), max_new_tokens=4,
                       request_id="live", adapter="busy")
    with pytest.raises(ValueError, match="live"):
        engine.unregister_adapter("busy")
    engine.run()
    assert engine.unregister_adapter("busy") == 1
    with pytest.raises(ValueError, match="max_adapters"):
        LLMEngine(tm, device="cpu").register_adapter("x", seed=1)


def test_registry_validation(models):
    _, tm = models
    ad = AdapterSet(tm, max_adapters=2, rank=2)
    assert ad.register("x", seed=1) == 1
    with pytest.raises(ValueError, match="already registered"):
        ad.register("x", seed=2)
    assert ad.register("y", seed=2) == 2
    with pytest.raises(ValueError, match="slots"):
        ad.register("z", seed=3)
    ad.unregister("y")
    with pytest.raises(KeyError):
        ad.slot_of("y")
    with pytest.raises(KeyError):
        ad.unregister("y")
    assert ad.slot_of(None) == 0
    assert all(float(t[2].abs().sum()) == 0.0
               for t in (*ad.a.values(), *ad.b.values()))
    L = tm.config.num_hidden_layers
    bad = {t: (np.zeros((L, 1, 1)), np.zeros((L, 1, 1)))
           for t in ("qkv", "out")}
    with pytest.raises(ValueError, match="want A"):
        ad.register("bad", weights=bad)
    with pytest.raises(ValueError):
        AdapterSet(tm, max_adapters=0, rank=2)
    with pytest.raises(ValueError):
        AdapterSet(tm, max_adapters=1, rank=0)
    with pytest.raises(ValueError):
        ad.register(None)


def test_registered_weights_equal_the_reference(models):
    """A seeded adapter draws the reference's factors; explicit weights go
    in as given; slot 0 stays zero."""
    jm, tm = models
    from paddle_tpu.serving import AdapterSet as JAdapterSet
    jad = JAdapterSet(jm, max_adapters=2, rank=3)
    ad = AdapterSet(tm, max_adapters=2, rank=3)
    rng = np.random.default_rng(3)
    L, h = CFG["num_hidden_layers"], CFG["hidden_size"]
    weights = {"qkv": (rng.normal(size=(L, h, 3)), rng.normal(size=(L, 3,
                                                                    3 * h))),
               "out": (rng.normal(size=(L, h, 3)), rng.normal(size=(L, 3,
                                                                    h)))}
    for package in (jad, ad):
        package.register("s", seed=4, scale=2.5)
        package.register("w", weights=weights, scale=0.5)
    for t in ("qkv", "out"):
        np.testing.assert_array_equal(ad.a[t].numpy(), jad._a[t])
        np.testing.assert_array_equal(ad.b[t].numpy(), jad._b[t])
    np.testing.assert_array_equal(ad.scale.numpy(), jad._scale)


def test_merged_folds_the_adapter_and_restores_the_weights(models):
    """`merged` changes the forward as the reference's merge does (its
    logits within 1e-5 of the JAX merged model's) and restores the base
    weights bit for bit on exit, in place."""
    jm, tm = models
    from paddle_tpu.serving import AdapterSet as JAdapterSet
    jad = JAdapterSet(jm, max_adapters=2, rank=2)
    ad = AdapterSet(tm, max_adapters=2, rank=2)
    for package in (jad, ad):
        package.register("m", seed=6, scale=25.0)
    ids = np.asarray([_prompt(8, seed=36)], np.int64)
    before = [p.detach().clone() for p in tm.parameters()]
    ptrs = [p.data_ptr() for p in tm.parameters()]
    with torch.no_grad():
        base = tm(torch.from_numpy(ids))
        with jad.merged("m"):
            want = np.asarray(jm(paddle.Tensor(ids))._value)
        with ad.merged("m"):
            got = tm(torch.from_numpy(ids))
        after = tm(torch.from_numpy(ids))
        with ad.merged(None):
            untouched = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert (got - base).abs().max() > 1e-3
    assert torch.equal(after, base) and torch.equal(untouched, base)
    assert all(torch.equal(p, q) for p, q in zip(tm.parameters(), before))
    assert [p.data_ptr() for p in tm.parameters()] == ptrs


# ---------------------------------------------------------------------------
# hot-swap
# ---------------------------------------------------------------------------

def _swap_pair():
    """Fresh (reference, port) models from seed 0 (a swap mutates them)
    and the seed-1 weights in each package's form."""
    jm1, tm1 = _pair(0)
    jm2, _ = _pair(1)
    named = _named(jm2)
    return jm1, tm1, [np.asarray(p._value) for p in jm2.parameters()], \
        jax_state_values(tm1, named)


@pytest.mark.parametrize("prefix", [False, True])
def test_swap_between_steps_equals_the_jax_engine(prefix):
    jm1, tm1, jw2, tw2 = _swap_pair()
    p = _prompt(12, seed=51)
    outs = []
    for engine, w2 in ((JLLMEngine(jm1, max_batch_size=2, block_size=4,
                                   num_blocks=64, hot_swap=True,
                                   enable_prefix_cache=prefix), jw2),
                       (LLMEngine(tm1, device="cpu", max_batch_size=2,
                                  block_size=4, num_blocks=64, hot_swap=True,
                                  enable_prefix_cache=prefix), tw2)):
        before = engine.generate([p], max_new_tokens=6)[0]
        if prefix:
            assert engine.stats()["prefix_entries"] > 0
        assert engine.swap_weights(w2) == 1 == engine.weight_epoch
        if prefix:
            assert engine.stats()["prefix_entries"] == 0
        after = engine.generate([list(p)], max_new_tokens=6)[0]
        st = engine.stats()
        outs.append((before, after, st["prefills"], st["weight_swaps"],
                     st["weight_epoch"], st["decode_compiles"]))
    assert outs[0] == outs[1]
    assert outs[1][0] != outs[1][1] and outs[1][2] == 2


@pytest.mark.parametrize("pipelined", [False, True])
def test_mid_run_swap_cutover_equals_the_jax_engine(pipelined):
    """Streams in flight at the cutover: every token before it is the old
    weights', every token after is the new weights' continuation of
    (prompt + old tokens), exactly as in the JAX engine swapped at the same
    boundary; the parameters keep their storage and nothing rebuilds."""
    jm1, tm1, jw2, tw2 = _swap_pair()
    prompts = [_prompt(8, seed=52), _prompt(10, seed=53)]
    ptrs = [p.data_ptr() for p in tm1.parameters()]
    runs = []
    for engine, w2 in ((JLLMEngine(jm1, max_batch_size=2, block_size=4,
                                   num_blocks=64, hot_swap=True), jw2),
                       (LLMEngine(tm1, device="cpu", max_batch_size=2,
                                  block_size=4, num_blocks=64, hot_swap=True,
                                  pipeline_decode=pipelined), tw2)):
        reqs = [engine.add_request(p, max_new_tokens=10,
                                   request_id=f"w{i}")
                for i, p in enumerate(prompts)]
        for _ in range(4):
            engine.step()
        engine._flush_inflight()          # both cut at a committed step
        marks = [len(r.generated) for r in reqs]
        engine.swap_weights(w2)
        engine.run()
        st = engine.stats()
        runs.append(([list(r.generated) for r in reqs], marks,
                     [r.preemptions for r in reqs], st["evictions"],
                     st["weight_swaps"], st["decode_compiles"]))
    assert runs[0] == runs[1]
    gens, marks, preempted, evictions, swaps, compiles = runs[1]
    assert all(k > 0 for k in marks) and all(n >= 1 for n in preempted)
    assert (evictions, swaps, compiles) == (0, 1, 1)
    assert [p.data_ptr() for p in tm1.parameters()] == ptrs
    assert all(torch.equal(p, torch.tensor(np.asarray(w)))
               for p, w in zip(tm1.parameters(), tw2))


def test_stage_identical_weights_is_a_noop(models):
    _, tm1, _, tw2 = _swap_pair()
    engine = LLMEngine(tm1, device="cpu", max_batch_size=2, block_size=4,
                       num_blocks=64, hot_swap=True)
    same = [p.detach().clone().numpy() for p in tm1.parameters()]
    assert engine.stage_weights(same) is False
    assert engine.weight_epoch == 0 and engine.stats()["weight_swaps"] == 0
    assert engine.stage_weights(tw2) is True
    with pytest.raises(ValueError, match="arrays"):
        engine.stage_weights(tw2[:-1])
    with pytest.raises(ValueError, match="shape"):
        engine.stage_weights([w.T for w in tw2])
    with pytest.raises(ValueError, match="hot_swap"):
        LLMEngine(models[1], device="cpu").stage_weights([])


def test_swap_from_a_streaming_callback_commits_at_the_boundary():
    _, tm1, _, tw2 = _swap_pair()
    engine = LLMEngine(tm1, device="cpu", max_batch_size=2, block_size=4,
                       num_blocks=64, hot_swap=True)
    seen = []

    def on_token(req, tok, text):
        seen.append(engine.weight_epoch)
        if len(seen) == 3:
            assert engine.swap_weights(tw2) == 0   # staged, not yet live

    engine.add_request(_prompt(9, seed=55), max_new_tokens=6,
                       on_token=on_token)
    engine.run()
    assert seen == [0, 0, 0, 1, 1, 1]
    assert engine.stats()["weight_swaps"] == 1
