"""Port parity: the hung-step watchdog, its ladder, and the eager fallback.

The reference's `tests/test_serving.py` `TestWatchdog` and
`TestDegradedFallback` cases on the port's engine, serial and pipelined,
with the streams held to the JAX engine's UNFAULTED streams:

  * one injected decode hang (rung 1): every stream finishes
    token-identically, `hangs` 1, no rebuild, the engine recovered;
  * two (rung 2): the program is rebuilt once (`decode_compiles` 2), the
    streams still identical;
  * a wedged step (its event never completes): the last rung within
    three budgets, the rebuild waiting for the wedged launch;
  * three (rung 3): the active requests fail with ``step_hang`` and a new
    request is served; pipelined, the commit's ladder fails them at the
    second hang;
  * a prefill hang: retried once, then the request fails alone;
  * a poisoned decode (``nan_output``): the launch is discarded, every
    running stream finishes through `GPTForCausalLM.generate`, callbacks
    included, no rebuild, and the engine serves new work on the same
    program; an adapter tenant's stream finishes under its merged weights;
    repeated fallbacks keep a bounded number of `generate` programs;
  * an error from the step's completion (organic fault) on a device that
    survives it: raised, the running requests fail with ``decode_fault``
    and none finishes eagerly; the pools are zeroed and the program
    rebuilt;
  * an error from the decode program's kernel wrapper (a build or launch
    failure) is raised as it is: no fallback, no failed request;
  * `MonitoredWait` on an event: its poll schedule, a hang
    raised within the budget plus one poll interval, ``stall`` sleeping the
    real budget, the budget read from ``FLAGS_serve_step_timeout_ms``.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import LLMEngine as JLLMEngine

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework import set_flags
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.incubate.models.gpt import GEN_CACHE_SIZE
from paddle_tpu_torch.nn.functional import attention
from paddle_tpu_torch.ops import guardian
from paddle_tpu_torch.serving import (FAILED, FINISHED, LLMEngine,
                                      MonitoredWait, StepHang,
                                      watchdog_budget_s)

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 128
CFG = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=1, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0, initializer_range=0.3)
ENGINE = dict(max_batch_size=2, block_size=4)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPTForCausalLM(JGPTConfig(**CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(autouse=True)
def no_faults_left():
    """Injectors and the watchdog flag are process-wide: each test starts
    and ends with none armed."""
    guardian.clear_faults()
    yield
    guardian.clear_faults()
    set_flags({"FLAGS_serve_step_timeout_ms": 0})


def _prompt(length, seed=0):
    rng = np.random.default_rng(seed * 1000 + length)
    return rng.integers(0, VOCAB, length).tolist()


def _jax_streams(jm, prompts, n, **kw):
    return JLLMEngine(jm, **ENGINE, **kw).generate(prompts, max_new_tokens=n)


# ---------------------------------------------------------------------------
# the watchdog's ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True])
def test_injected_hang_recovers_within_budget(models, pipelined):
    """Rung 1: a hung decode is waited for again; the streams finish
    token-identically, without a rebuild, and the engine recovers."""
    jm, tm = models
    prompts = [_prompt(n, seed=31) for n in (9, 6)]
    want = _jax_streams(jm, prompts, 8)
    set_flags({"FLAGS_serve_step_timeout_ms": 2000})
    engine = LLMEngine(tm, device="cpu", pipeline_decode=pipelined, **ENGINE)
    reqs = [engine.add_request(p, max_new_tokens=8) for p in prompts]
    for _ in range(3):
        engine.step()
    guardian.inject_fault("hang", op="serve.decode", times=1)
    engine.run()
    st = engine.stats()
    assert st["hangs"] == 1 and st["decode_compiles"] == 1
    assert not engine.degraded
    assert [r.generated for r in reqs] == want
    assert all(r.state == FINISHED for r in reqs)


def test_two_hangs_rebuild_the_program_once(models):
    """Rung 2 (serial): the second firing rebuilds the decode program,
    counted; the same launch is waited for again and the streams stay
    identical."""
    jm, tm = models
    prompts = [_prompt(n, seed=36) for n in (7, 10)]
    want = _jax_streams(jm, prompts, 7)
    engine = LLMEngine(tm, device="cpu", **ENGINE)
    reqs = [engine.add_request(p, max_new_tokens=7) for p in prompts]
    engine.step()
    guardian.inject_fault("hang", op="serve.decode", times=2)
    engine.run()
    st = engine.stats()
    assert st["hangs"] == 2 and st["decode_compiles"] == 2
    assert engine.degrade_reason is not None and not engine.degraded
    assert [r.generated for r in reqs] == want


class _Wedge:
    """The events of a device that finishes nothing until `released`."""

    released = False

    def query(self):
        return self.released

    def synchronize(self):
        pass


@pytest.mark.parametrize("pipelined, hangs", [(False, 3), (True, 2)])
def test_a_wedged_step_reaches_the_last_rung_within_its_budgets(
        models, pipelined, hangs):
    """A step whose event never completes: the ladder fails the active
    request with ``step_hang`` within `hangs` budgets (rung 2 waits
    again and does not rebuild: a capture would wait for the wedged
    device); the rebuild runs at the first launch after the wedge has
    cleared, and new work is served with the unfaulted tokens."""
    jm, tm = models
    budget = 0.05
    set_flags({"FLAGS_serve_step_timeout_ms": budget * 1e3})
    engine = LLMEngine(tm, device="cpu", pipeline_decode=pipelined, **ENGINE)
    doomed = engine.add_request(_prompt(6, seed=44), max_new_tokens=8)
    engine.step()
    engine.step()
    wedge = _Wedge()
    engine._event = lambda: wedge
    t0 = time.perf_counter()
    while doomed.state != FAILED and engine.step():
        pass
    elapsed = time.perf_counter() - t0
    assert doomed.error == "step_hang" and engine.stats()["hangs"] == hangs
    assert hangs * budget <= elapsed < hangs * budget + 0.25
    assert engine.stats()["decode_compiles"] == 1 and engine._decode_stale
    wedge.released = True
    del engine._event
    fresh = engine.add_request(_prompt(5, seed=45), max_new_tokens=4)
    engine.run()
    assert engine.stats()["decode_compiles"] == 2
    assert fresh.generated == _jax_streams(jm, [_prompt(5, seed=45)], 4)[0]


@pytest.mark.parametrize("pipelined, hangs", [(False, 3), (True, 2)])
def test_hangs_fail_active_without_wedging(models, pipelined, hangs):
    """The last rung: a step that will not come back fails the ACTIVE
    requests with ``step_hang`` (the pipelined commit at its second hang:
    a wedged device holds both outstanding launches); queued and new
    requests are then served normally."""
    jm, tm = models
    set_flags({"FLAGS_serve_step_timeout_ms": 2000})
    engine = LLMEngine(tm, device="cpu", pipeline_decode=pipelined, **ENGINE)
    doomed = engine.add_request(_prompt(6, seed=32), max_new_tokens=8)
    engine.step()
    guardian.inject_fault("hang", op="serve.decode", times=3)
    engine.run()
    guardian.clear_faults()
    assert doomed.state == FAILED and doomed.error == "step_hang"
    st = engine.stats()
    assert st["hangs"] == hangs and st["failed"] == 1
    assert engine.degraded and engine.degrade_reason[1]["rung"] == \
        "fail_active"
    fresh = engine.add_request(_prompt(5, seed=33), max_new_tokens=4)
    engine.run()
    assert fresh.state == FINISHED
    assert fresh.generated == _jax_streams(jm, [_prompt(5, seed=33)], 4)[0]
    assert not engine.degraded


def test_prefill_hang_retries_then_fails_the_request_alone(models):
    jm, tm = models
    engine = LLMEngine(tm, device="cpu", **ENGINE)
    first = engine.add_request(_prompt(8, seed=37), max_new_tokens=5)
    engine.step()
    guardian.inject_fault("hang", op="serve.prefill", times=1)
    retried = engine.add_request(_prompt(6, seed=38), max_new_tokens=5)
    engine.step()
    assert engine.stats()["hangs"] == 1 and retried.state != FAILED
    doomed = engine.add_request(_prompt(7, seed=39), max_new_tokens=5)
    guardian.inject_fault("hang", op="serve.prefill", times=2)
    engine.run()
    assert doomed.state == FAILED and doomed.error == "step_hang"
    assert engine.stats()["hangs"] == 3 and engine.stats()["failed"] == 1
    want = _jax_streams(jm, [_prompt(8, seed=37), _prompt(6, seed=38)], 5)
    assert [first.generated, retried.generated] == want


# ---------------------------------------------------------------------------
# the eager fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True])
def test_poisoned_decode_falls_back_eager_token_identically(models,
                                                            pipelined):
    """A poisoned decode launch is discarded; every running stream
    finishes through `generate` with the unfaulted engine's tokens,
    streaming callbacks included, and the engine keeps serving new work on
    the unrebuilt program."""
    jm, tm = models
    prompts = [_prompt(n, seed=34) for n in (10, 7)]
    want = _jax_streams(jm, prompts, 9)
    engine = LLMEngine(tm, device="cpu", pipeline_decode=pipelined, **ENGINE)
    streamed = {"a": [], "b": []}
    reqs = [engine.add_request(
        p, max_new_tokens=9, request_id=rid,
        on_token=lambda r, tok, text: streamed[r.rid].append(tok))
        for rid, p in zip(("a", "b"), prompts)]
    for _ in range(4):
        engine.step()
    guardian.inject_fault("nan_output", op="serve.decode", times=1)
    engine.run()
    st = engine.stats()
    assert st["eager_fallbacks"] == 2 and st["decode_compiles"] == 1
    assert engine.degrade_reason[0] == "decode_fault"
    for r, ref in zip(reqs, want):
        assert r.state == FINISHED and r.generated == ref
        assert streamed[r.rid] == ref
    again = engine.add_request(prompts[0], max_new_tokens=9)
    engine.run()
    assert again.generated == want[0]
    assert engine.stats()["decode_compiles"] == 1 and not engine.degraded


def test_adapter_tenant_falls_back_under_its_merged_weights(models):
    """An adapter tenant's stream finishes through `generate` under
    `AdapterSet.merged`, with the unfaulted JAX engine's tokens; the base
    weights are back, bit for bit, afterwards."""
    jm, tm = models
    kw = dict(max_batch_size=2, block_size=4, max_adapters=2,
              adapter_rank=2)
    prompts = [_prompt(9, seed=41), _prompt(6, seed=42)]
    plan = ["t1", None]

    def streams(engine, fault):
        engine.register_adapter("t1", seed=1, scale=25.0)
        reqs = [engine.add_request(p, max_new_tokens=7, adapter=ad)
                for p, ad in zip(prompts, plan)]
        for _ in range(3):
            engine.step()
        if fault:
            guardian.inject_fault("nan_output", op="serve.decode", times=1)
        engine.run()
        return [r.generated for r in reqs]

    want = streams(JLLMEngine(jm, **kw), fault=False)
    before = [p.detach().clone() for p in tm.parameters()]
    engine = LLMEngine(tm, device="cpu", **kw)
    assert streams(engine, fault=True) == want
    assert engine.stats()["eager_fallbacks"] == 2
    assert all(torch.equal(a, b) for a, b in zip(before, tm.parameters()))


def test_repeated_fallbacks_keep_few_generate_programs(models):
    """Each fallback finishes its stream through a `generate` signature of
    its own length; the model keeps only the last GEN_CACHE_SIZE."""
    jm, tm = models
    engine = LLMEngine(tm, device="cpu", **ENGINE)
    for round_ in range(3):
        prompts = [_prompt(n, seed=46 + round_) for n in (5 + round_, 9)]
        reqs = [engine.add_request(p, max_new_tokens=6) for p in prompts]
        engine.step()
        guardian.inject_fault("nan_output", op="serve.decode", times=1)
        engine.run()
        assert [r.generated for r in reqs] == _jax_streams(jm, prompts, 6)
    assert engine.stats()["eager_fallbacks"] == 6
    assert len(tm._gen_cache) <= GEN_CACHE_SIZE


@pytest.mark.parametrize("pipelined", [False, True])
def test_organic_fault_finishes_eagerly_and_resets_the_pools(models,
                                                             pipelined):
    """An error from a step's completion that a device synchronize does
    not repeat: it is raised, every running request fails with
    ``decode_fault`` (the tokens streamed before it are the unfaulted
    ones) and none finishes on another path; the pools are zeroed with a
    fresh allocator, the program is rebuilt, and new work is served as
    before."""
    jm, tm = models
    prompts = [_prompt(n, seed=43) for n in (8, 5)]
    want = _jax_streams(jm, prompts, 8)
    engine = LLMEngine(tm, device="cpu", pipeline_decode=pipelined, **ENGINE)
    reqs = [engine.add_request(p, max_new_tokens=8) for p in prompts]
    for _ in range(3):
        engine.step()
    read = engine._read_outputs
    calls = []

    def faulting(out):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("an error the step's event reported")
        return read(out)

    engine._read_outputs = faulting
    with pytest.raises(RuntimeError, match="the step's event reported"):
        engine.run()
    for r, ref in zip(reqs, want):
        assert r.state == FAILED and r.error == "decode_fault"
        assert r.generated == ref[:len(r.generated)]
    st = engine.stats()
    assert st["eager_fallbacks"] == 0 and st["decode_compiles"] == 2
    assert st["failed"] == 2 and engine.degrade_reason[0] == "decode_fault"
    assert not bool(engine.cache.k_pools.any())
    assert engine.cache.allocator.num_free == engine.cache.allocator.capacity
    again = engine.add_request(prompts[1], max_new_tokens=8)
    engine.run()
    assert again.generated == want[1]


@pytest.mark.parametrize("pipelined", [False, True])
def test_a_failing_kernel_wrapper_is_raised_not_replaced(models, monkeypatch,
                                                         pipelined):
    """An error from the decode program's own kernel wrapper (as a kernel
    that fails to build or launch raises) leaves the watchdog's and the
    fault path's hands: `step()` raises it, no stream finishes through
    `generate`, and no request fails or is retired."""
    _, tm = models
    engine = LLMEngine(tm, device="cpu", pipeline_decode=pipelined, **ENGINE)
    reqs = [engine.add_request(_prompt(n, seed=47), max_new_tokens=8)
            for n in (7, 5)]
    engine.step()

    def failing(*args, **kwargs):
        raise RuntimeError("paged_decode_append launch failed: cudaError 98")

    monkeypatch.setattr(attention, "paged_decode_append", failing)
    with pytest.raises(RuntimeError, match="launch failed"):
        engine.step()
    st = engine.stats()
    assert st["eager_fallbacks"] == 0 and st["failed"] == 0
    assert not engine.degraded
    assert all(r.state != FAILED and not r.finished for r in reqs)


# ---------------------------------------------------------------------------
# MonitoredWait
# ---------------------------------------------------------------------------

class _Event:
    """A stand-in for a CUDA event: done after `polls` queries (None:
    never), counting the queries."""

    def __init__(self, polls=None):
        self.polls = polls
        self.queries = 0

    def query(self):
        self.queries += 1
        return self.polls is not None and self.queries > self.polls


def test_wait_returns_once_the_event_completes():
    event = _Event(polls=50)
    MonitoredWait(budget_s=2.0).wait(event, "decode")
    assert event.queries == 51


def test_wait_raises_within_the_budget_plus_one_poll():
    budget = 0.05
    t0 = time.perf_counter()
    with pytest.raises(StepHang) as ei:
        MonitoredWait(budget_s=budget).wait(_Event(), "decode", attempt=2)
    elapsed = time.perf_counter() - t0
    assert budget <= elapsed < budget + 0.02
    assert ei.value.phase == "decode" and ei.value.attempt == 2


def test_wait_is_free_when_disarmed_and_reads_the_flag():
    event = _Event()
    assert watchdog_budget_s() is None and not MonitoredWait().armed
    MonitoredWait().wait(event, "decode")       # never polls the event
    assert event.queries == 0
    set_flags({"FLAGS_serve_step_timeout_ms": 250})
    assert watchdog_budget_s() == 0.25 and MonitoredWait().armed


def test_injected_stall_burns_the_budget_and_hang_does_not():
    wait = MonitoredWait(budget_s=0.05)
    guardian.inject_fault("hang", op="serve.decode", times=1)
    t0 = time.perf_counter()
    with pytest.raises(StepHang):
        wait.wait(None, "decode")
    assert time.perf_counter() - t0 < 0.02
    guardian.inject_fault("stall", op="serve.decode", times=1)
    t0 = time.perf_counter()
    with pytest.raises(StepHang):
        wait.wait(None, "decode")
    assert time.perf_counter() - t0 >= 0.05
    wait.wait(None, "decode")                    # both fired their once


def test_fault_kinds_and_sites():
    with pytest.raises(ValueError):
        guardian.inject_fault("melt")
    inj = guardian.inject_fault("hang", op="serve.prefill", after=1, times=2)
    assert guardian.poll_fault("serve.decode", ("hang",)) is None
    assert guardian.poll_fault("serve.prefill", ("hang",)) is None  # after
    assert guardian.poll_fault("serve.prefill", ("nan_output",)) is None
    assert guardian.poll_fault("serve.prefill", ("hang",)) == "hang"
    assert guardian.poll_fault("serve.prefill", ("hang",)) == "hang"
    assert guardian.poll_fault("serve.prefill", ("hang",)) is None
    inj.remove()
    assert not guardian.faults_armed()
