"""Port parity: paddle_tpu_torch serving vs the JAX package's.

  * greedy decode: the port's `LLMEngine.generate` is token-identical to
    the JAX `LLMEngine.generate` and to the JAX `model.generate(
    do_sample=False)` on the same weights — mixed lengths, more requests
    than slots, a pool small enough to force preemption, and EOS;
  * the sampling processors compute the JAX masks on the same logits
    (1e-6, fp32: the same elementwise arithmetic), and a stochastic stream
    replays itself byte-identically (its draw is keyed as the JAX
    engine's: tests/test_torch_sampling_keyed.py holds the two equal);
  * the scheduler policy cases of tests/test_serving.py, on the port's
    own copy of the scheduler;
  * entry points default to cuda and raise here, where there is no card.

The model is tiny (vocab 128, hidden 64, one head of 64, so prefill takes
the flash route and decode the paged route, through their plain twins on
the CPU).
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import LLMEngine as JLLMEngine
from paddle_tpu.serving import num_blocks_for_bytes as j_num_blocks
from paddle_tpu.serving import pool_bytes_per_block as j_pool_bytes
from paddle_tpu.serving import sampling as jsamp

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (BlockAllocator, CANCELLED, EXPIRED,
                                      FINISHED, LLMEngine, NULL_BLOCK,
                                      QUEUED, RUNNING, Request, Scheduler,
                                      ServeRefusal, num_blocks_for_bytes,
                                      pool_bytes_per_block)
from paddle_tpu_torch.kernels import sampler_filter as sf
from paddle_tpu_torch.serving import sampling as tsamp

VOCAB = 128
CFG = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=1, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run each test on one torch intra-op thread. pytest-xdist's workers
    share the machine's cores, and torch's default of a thread per core in
    every worker oversubscribes them: these small-tensor tests then run
    many times slower and load the machine for every other test. The
    other port test files that run engines import this fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


_REF = {}


def _ref(jm, prompt, n):
    key = (tuple(prompt), n)
    if key not in _REF:
        out = jm.generate(paddle.Tensor(np.asarray([prompt], np.int64)),
                          max_new_tokens=n, do_sample=False)
        _REF[key] = np.asarray(out._value)[0].tolist()
    return _REF[key]


# ---------------------------------------------------------------------------
# greedy parity with the JAX engine and model.generate
# ---------------------------------------------------------------------------

CASES = {
    "mixed_lengths": dict(lens=(11, 5, 17, 3), seed=0, new=10,
                          kw=dict(max_batch_size=4, block_size=4)),
    "more_requests_than_slots": dict(lens=(9, 4, 13, 6, 2, 15), seed=1,
                                     new=8, kw=dict(max_batch_size=2,
                                                    block_size=4)),
    "preemption": dict(lens=(11, 12, 10, 5), seed=5, new=10,
                       kw=dict(max_batch_size=3, block_size=4,
                               num_blocks=10, watermark_blocks=1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_matches_jax_engine_and_generate(models, case):
    jm, tm = models
    c = CASES[case]
    prompts = [_prompt(n, seed=c["seed"]) for n in c["lens"]]
    refs = [_ref(jm, p, c["new"]) for p in prompts]
    j_outs = JLLMEngine(jm, **c["kw"]).generate(prompts,
                                                max_new_tokens=c["new"])
    engine = LLMEngine(tm, device="cpu", **c["kw"])
    outs = engine.generate(prompts, max_new_tokens=c["new"])
    assert j_outs == refs
    assert outs == refs
    st = engine.stats()
    assert st["completed"] == len(prompts)
    if case == "preemption":
        assert st["evictions"] >= 1        # the tight pool actually bit
        assert any(r.preemptions for r in engine.requests.values())


def test_eos_stops_a_stream_early(models):
    jm, tm = models
    p = _prompt(7)
    ref = _ref(jm, p, 12)
    eos = ref[4]
    engine = LLMEngine(tm, max_batch_size=2, block_size=4, device="cpu")
    req = engine.add_request(p, max_new_tokens=12, eos_token_id=eos)
    engine.run()
    assert req.state == FINISHED
    stop = ref.index(eos)                  # the FIRST occurrence
    assert req.generated == ref[:stop + 1]
    assert len(req.generated) < 12


def test_streaming_callbacks_and_kv_refusal(models):
    jm, tm = models
    small = LLMEngine(tm, max_batch_size=2, block_size=4, num_blocks=6,
                      watermark_blocks=1, device="cpu")
    with pytest.raises(ServeRefusal, match="KV blocks at peak") as err:
        small.add_request(_prompt(20), max_new_tokens=20)
    assert err.value.reason == "kv_exhausted"
    assert small.stats()["refused"] == 1
    ok = small.add_request(_prompt(4), max_new_tokens=4)   # fits: queued
    p = _prompt(9)
    seen = []
    engine = LLMEngine(tm, max_batch_size=2, block_size=4, device="cpu")
    engine.add_request(p, max_new_tokens=8,
                       on_token=lambda r, tok, text: seen.append(tok))
    engine.run()
    small.run()
    assert seen == _ref(jm, p, 8)
    assert ok.generated == _ref(jm, _prompt(4), 4)


def test_refusals_cancel_expiry_and_tokenizer(models):
    """The reference's host-side admission policy, cancellation and
    deadline sweep, ported as they are."""
    _, tm = models

    class Tok:
        def decode(self, ids):
            return f"<{ids[0]}>"

    texts = []
    engine = LLMEngine(tm, max_batch_size=1, block_size=4, max_queue_depth=2,
                       tokenizer=Tok(), device="cpu")
    with pytest.raises(ServeRefusal) as err:
        engine.add_request(_prompt(3), 4, temperature=-1.0)
    assert err.value.reason == "sampler_mismatch"
    a = engine.add_request(_prompt(5), 6,
                           on_token=lambda r, t, text: texts.append((t, text)))
    b = engine.add_request(_prompt(6), 6)
    with pytest.raises(ServeRefusal) as err:
        engine.add_request(_prompt(7), 6)
    assert err.value.reason == "queue_full"
    engine.step()                        # a takes the only slot, b waits
    assert a.state == RUNNING and b.state == QUEUED
    assert engine.cancel(b.rid) and b.state == CANCELLED
    with pytest.raises(ServeRefusal) as err:
        engine.add_request(_prompt(4), 4, ttl_s=0.0)
    assert err.value.reason == "deadline_infeasible"
    c = engine.add_request(_prompt(4), 4, ttl_s=60.0)
    c.deadline_ns = time.perf_counter_ns() - 1    # the TTL runs out queued
    engine.step()
    assert c.state == EXPIRED and c.error == "deadline_expired"
    assert engine.cancel(a.rid) and a.state == CANCELLED
    assert not engine._active.any() and not engine.step()
    assert texts and all(text == f"<{t}>" for t, text in texts)
    st = engine.stats()
    assert (st["refused"], st["refused_queue_full"], st["refused_deadline"],
            st["cancelled"], st["expired"]) == (3, 1, 1, 2, 1)
    assert set(engine.pop_finished()) == {a.rid, b.rid, c.rid}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_pool_sizing_matches_jax(dtype):
    for budget in (1 << 20, 1 << 30):
        assert pool_bytes_per_block(12, 12, 64, 16, getattr(torch, dtype)) \
            == j_pool_bytes(12, 12, 64, 16, getattr(jnp, dtype))
        assert num_blocks_for_bytes(budget, 2, 4, 16, 4,
                                    getattr(torch, dtype)) \
            == j_num_blocks(budget, 2, 4, 16, 4, getattr(jnp, dtype))


# ---------------------------------------------------------------------------
# sampling processors and stochastic replay
# ---------------------------------------------------------------------------

def _logits(seed=0, s=4, v=50):
    rng = np.random.default_rng(seed)
    return (3.0 * rng.standard_normal((s, v))).astype(np.float32)


def test_processors_match_jax():
    lg = _logits()
    hist = np.random.default_rng(1).integers(0, 50, (4, 12)).astype(np.int32)
    valid = np.arange(12)[None, :] < np.array([[0], [3], [7], [12]])
    pen = np.array([1.0, 1.3, 0.7, 2.0], np.float32)
    temp = np.array([0.0, 0.5, 1.0, 1.7], np.float32)
    topk = np.array([0, 1, 5, 50], np.int32)
    topp = np.array([1.0, 0.3, 0.9, 0.5], np.float32)
    t = torch.from_numpy
    j = jnp.asarray
    pairs = [
        (sf.apply_repetition_penalty(t(lg), t(hist), t(valid), t(pen)),
         jsamp.apply_repetition_penalty(j(lg), j(hist), j(valid), j(pen))),
        (sf.apply_temperature(t(lg), t(temp)),
         jsamp.apply_temperature(j(lg), j(temp))),
        (tsamp.apply_top_k(t(lg), t(topk)), jsamp.apply_top_k(j(lg), j(topk))),
        (tsamp.apply_top_p(t(lg), t(topp)), jsamp.apply_top_p(j(lg), j(topp))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    # the engine's combined filter keeps exactly the tokens both JAX
    # filters keep, computed on the same post-temperature logits
    got = sf.sampler_filter(t(lg), t(temp + 0.1), t(topk), t(topp),
                            t(pen), t(hist), t(valid)).numpy()
    pre = jsamp.apply_temperature(
        jsamp.apply_repetition_penalty(j(lg), j(hist), j(valid), j(pen)),
        j(temp + 0.1))
    keep = (np.asarray(jsamp.apply_top_k(pre, j(topk))) > -1e29) \
        & (np.asarray(jsamp.apply_top_p(pre, j(topp))) > -1e29)
    np.testing.assert_array_equal(got > -1e29, keep)
    np.testing.assert_allclose(got[keep], np.asarray(pre)[keep], rtol=1e-6)


def test_greedy_head_is_raw_argmax_with_logprobs():
    lg = _logits(seed=2)
    s = lg.shape[0]
    t = torch.from_numpy
    out = tsamp.sample_tokens(
        t(lg), t(np.zeros(s, np.float32)), t(np.zeros(s, np.int32)),
        t(np.ones(s, np.float32)), t(np.ones(s, np.float32)),
        t(np.zeros(s, np.int32)), t(np.ones(s, np.int32)),
        t(np.zeros((s, 1), np.int32)), t(np.zeros((s, 1), bool)),
        logprobs_topk=3)
    nxt, chosen, alt_ids, alt_lps = (o.numpy() for o in out)
    np.testing.assert_array_equal(nxt, lg.argmax(-1))
    logp = lg - np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1,
                       keepdims=True)) - lg.max(-1, keepdims=True)
    np.testing.assert_allclose(chosen, logp[np.arange(s), nxt], rtol=1e-5)
    np.testing.assert_array_equal(alt_ids[:, 0], nxt)
    assert alt_lps.shape == (s, 3)


def test_sampled_stream_replays_byte_identically(models):
    _, tm = models
    prompts = [_prompt(6, seed=7), _prompt(10, seed=8)]

    def run(seed):
        engine = LLMEngine(tm, max_batch_size=2, block_size=4,
                           device="cpu")
        reqs = [engine.add_request(p, max_new_tokens=12, temperature=0.8,
                                   top_k=40, top_p=0.95, seed=seed + i)
                for i, p in enumerate(prompts)]
        engine.add_request(_prompt(5), max_new_tokens=12)   # greedy neighbour
        engine.run()
        return [(r.generated, r.token_logprobs) for r in reqs]

    first = run(11)
    assert run(11) == first                 # same tokens, same logprobs
    assert run(12) != first                 # another seed, another stream


# ---------------------------------------------------------------------------
# scheduler policy (the port's copy; pure host-side)
# ---------------------------------------------------------------------------

def _sched(num_slots=2, num_blocks=9, block_size=4, watermark=1):
    alloc = BlockAllocator(num_blocks)
    return Scheduler(num_slots, alloc, block_size,
                     watermark_blocks=watermark), alloc


class TestSchedulerPolicy:
    def test_allocator_all_or_nothing_and_null_guard(self):
        alloc = BlockAllocator(4)
        assert alloc.capacity == 3
        assert alloc.allocate(4) is None
        got = alloc.allocate(3)
        assert len(got) == 3 and NULL_BLOCK not in got
        with pytest.raises(ValueError):
            alloc.free([NULL_BLOCK])
        alloc.free(got)
        assert alloc.num_free == 3

    def test_fcfs_head_only_no_skipping(self):
        sched, _ = _sched(num_slots=2, num_blocks=9, watermark=0)
        big = Request("big", list(range(20)), 4)
        small = Request("small", [1], 2)
        sched.enqueue(big)
        sched.enqueue(small)
        assert sched.try_admit() is big
        assert sched.try_admit() is small

    def test_watermark_blocks_admission(self):
        sched, _ = _sched(num_slots=2, num_blocks=9, watermark=2)
        a = Request("a", list(range(20)), 2)
        b = Request("b", [1, 2, 3, 4], 2)
        sched.enqueue(a)
        sched.enqueue(b)
        assert sched.try_admit() is a
        assert sched.try_admit() is None
        assert b.state == QUEUED
        assert sched.waiting == [b]

    def test_growth_dips_into_watermark(self):
        sched, alloc = _sched(num_slots=1, num_blocks=4, watermark=2)
        r = Request("r", [1, 2, 3], 8)
        sched.enqueue(r)
        assert sched.try_admit() is r
        assert sched.grow(r) and sched.grow(r)
        assert alloc.num_free == 0

    def test_preempt_victim_is_lifo_and_requeue_keeps_arrival_order(self):
        sched, _ = _sched(num_slots=3, num_blocks=20, watermark=0)
        reqs = [Request(f"r{i}", [1, 2], 4) for i in range(3)]
        for r in reqs:
            sched.enqueue(r)
        for _ in range(3):
            assert sched.try_admit() is not None
        victim = sched.preempt_victim()
        assert victim is reqs[2]
        sched.preempt(victim)
        assert victim.state == QUEUED and victim.blocks == []
        assert victim.preemptions == 1
        late = Request("late", [1], 2)
        sched.enqueue(late)
        assert sched.waiting.index(victim) < sched.waiting.index(late)

    def test_release_returns_blocks_and_slot(self):
        sched, alloc = _sched(num_slots=1, num_blocks=9, watermark=0)
        r = Request("r", list(range(6)), 2)
        sched.enqueue(r)
        sched.try_admit()
        assert r.blocks
        sched.release(r)
        assert alloc.num_free == 8 and sched.slots == [None]

    def test_can_ever_fit_respects_watermark(self):
        sched, _ = _sched(num_slots=1, num_blocks=4, block_size=4,
                          watermark=0)
        assert sched.block_budget() == 3
        assert sched.can_ever_fit(Request("ok", [1] * 8, 4))
        assert not sched.can_ever_fit(Request("big", [1] * 8, 20))
        sched2, _ = _sched(num_slots=1, num_blocks=4, block_size=4,
                           watermark=1)
        assert not sched2.can_ever_fit(Request("ok", [1] * 8, 4))


# ---------------------------------------------------------------------------
# device rule and unported options
# ---------------------------------------------------------------------------

def test_engine_without_device_raises_here(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(models[1])


@pytest.mark.parametrize("kw", [dict(kv_dtype=torch.float16),
                                dict(attention_kernel="pallas")])
def test_unported_options_raise(models, kw):
    """float16 pools and the attention-kernel switch, once refused: the
    engine builds with each and serves the JAX engine's greedy streams
    under the same option."""
    jm, tm = models
    jkw = {k: (jnp.float16 if v is torch.float16 else v)
           for k, v in kw.items()}
    prompts = [_prompt(n, seed=5) for n in (7, 12, 4)]
    je = JLLMEngine(jm, max_batch_size=2, block_size=4, **jkw)
    te = LLMEngine(tm, device="cpu", max_batch_size=2, block_size=4, **kw)
    jr = [je.add_request(p, max_new_tokens=6) for p in prompts]
    tr = [te.add_request(p, max_new_tokens=6) for p in prompts]
    je.run()
    te.run()
    assert [r.generated for r in tr] == [r.generated for r in jr]
    if "attention_kernel" in kw:
        assert te.stats()["attention_kernel"] == "pallas"
    else:
        assert te.cache.k_pools.dtype == torch.float16


def test_adapter_request_without_adapters_refused(models):
    """An engine built without adapters refuses every adapter request as
    `adapter_mismatch`, as the reference's does."""
    engine = LLMEngine(models[1], device="cpu", max_batch_size=2,
                       block_size=4)
    with pytest.raises(ServeRefusal) as ei:
        engine.add_request(_prompt(5, seed=34), max_new_tokens=4,
                           adapter="anyone")
    assert ei.value.reason == "adapter_mismatch"
    assert ei.value.detail["registered"] == []
    assert engine.scheduler.waiting == [] and engine.requests == {}
