"""Pipelined decode in the port: step N+1 launches before step N commits.

`LLMEngine(pipeline_decode=True)` launches each decode step on the
tokens the previous step left in the device feedback buffer, then commits
the previous step (streams its tokens, retires requests) while the new
one runs. It must change WHEN tokens are committed, never WHICH:

  * mixed greedy and sampled streams (the reference's TestPipelined
    scenario) equal the unpipelined engine's bitwise, logprobs included,
    with one decode build each and no rollback on a clean drain, for fp32
    and int8 pools;
  * they equal the JAX package's UNPIPELINED engine's streams (the JAX
    pipelined engine is not the yardstick: it hands host arrays it then
    rewrites to an asynchronous call, a race the port does not copy);
  * a cancel between launch and commit rolls the launched token back
    (never appended, counted in `commit_rollbacks`), as does an EOS that
    ends a stream with a launch in flight; a tight pool's evictions and
    churn leave the streams equal too;
  * every launch's outputs stay intact in their own host buffer until
    the commit reads them, and the staging copies alternate buffers;
  * a step in which no launched slot samples takes the greedy head, and
    the streams equal an engine's that takes the full head every step,
    pipelined and not;
  * a streaming callback that raises mid-commit loses no token: the
    commit emits every record of its launch before the exception leaves
    `step()`, and each stream equals the unpipelined engine's under the
    same raise; raised on a stream's last token (max_new_tokens or EOS),
    it still retires the stream there, in both engines.

The model is tests/test_torch_serving.py's tiny GPT (vocab 128, hidden
64, one head of 64, two layers), CPU on both sides.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import LLMEngine as JLLMEngine

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import CANCELLED, FINISHED, LLMEngine

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 128
CFG = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=1, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
# the reference's sampler mix (tests/test_sampling.py SAMPLERS)
SAMPLERS = (
    dict(),
    dict(temperature=0.7, seed=11),
    dict(temperature=1.0, top_k=12, seed=12),
    dict(temperature=0.9, top_p=0.85, seed=13),
    dict(temperature=1.1, top_k=24, top_p=0.9, repetition_penalty=1.3,
         seed=14),
)
# three slots over 10 blocks of 4 tokens, one held back: streams evict
TIGHT = dict(max_batch_size=3, block_size=4, num_blocks=10,
             watermark_blocks=1)


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


def _streams(engine_cls, model, prompts, cfgs, n_new=8, **kw):
    """One engine, one request per (prompt, sampler cfg): the requests'
    (tokens, logprobs) in order, and the engine."""
    kw = {"max_batch_size": 4, "block_size": 4, **kw}
    if engine_cls is LLMEngine:
        kw["device"] = "cpu"
    engine = engine_cls(model, **kw)
    reqs = [engine.add_request(p, max_new_tokens=n_new, **c)
            for p, c in zip(prompts, cfgs)]
    engine.run()
    return [(list(r.generated), list(r.token_logprobs)) for r in reqs], engine


def _mix(seed=64, lengths=(9, 6, 11, 7, 8)):
    prompts = [_prompt(n, seed=seed) for n in lengths]
    cfgs = [dict(SAMPLERS[i % len(SAMPLERS)]) for i in range(len(prompts))]
    return prompts, cfgs


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pipelined_equals_unpipelined(models, kv_dtype):
    _, tm = models
    prompts, cfgs = _mix()
    plain, e1 = _streams(LLMEngine, tm, prompts, cfgs, kv_dtype=kv_dtype)
    piped, e2 = _streams(LLMEngine, tm, prompts, cfgs, kv_dtype=kv_dtype,
                         pipeline_decode=True)
    assert piped == plain                       # tokens AND logprobs
    assert e1.stats()["decode_compiles"] == 1
    assert e2.stats()["decode_compiles"] == 1
    assert e2.stats()["commit_rollbacks"] == 0
    assert e2.stats()["sampled_tokens"] == e1.stats()["sampled_tokens"] > 0
    assert all(len(toks) == 8 for toks, _ in piped)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("mix", [64, 70])
def test_streams_equal_the_jax_unpipelined_engine(models, kv_dtype, mix):
    jm, tm = models
    prompts, cfgs = _mix(seed=mix)
    want, _ = _streams(JLLMEngine, jm, prompts, cfgs, kv_dtype=kv_dtype)
    for pipelined in (False, True):
        got, engine = _streams(LLMEngine, tm, prompts, cfgs,
                               kv_dtype=kv_dtype, pipeline_decode=pipelined)
        assert [t for t, _ in got] == [t for t, _ in want], pipelined
        # logprobs: float32 log-softmax of each package's own logits
        np.testing.assert_allclose(
            np.array([lp for _, lps in got for lp in lps]),
            np.array([lp for _, lps in want for lp in lps]),
            rtol=0, atol=1e-4)
        assert engine.stats()["decode_compiles"] == 1


def test_cancel_between_launch_and_commit_rolls_back(models):
    _, tm = models
    prompts = [_prompt(n, seed=65) for n in (10, 8, 9)]
    cfgs = [dict(temperature=0.9, top_k=20, seed=5000 + i) for i in range(3)]
    plain, _ = _streams(LLMEngine, tm, prompts, cfgs, n_new=10)
    engine = LLMEngine(tm, max_batch_size=4, block_size=4,
                       pipeline_decode=True, device="cpu")
    reqs = [engine.add_request(p, max_new_tokens=10, **c)
            for p, c in zip(prompts, cfgs)]
    for _ in range(4):
        engine.step()
    assert engine._inflight is not None        # a launch awaits its commit
    victim = reqs[1]
    n_before = len(victim.generated)
    engine.cancel(victim.rid)
    engine.run()
    st = engine.stats()
    assert victim.state == CANCELLED
    assert len(victim.generated) == n_before    # nothing leaked
    assert st["commit_rollbacks"] == 1
    assert st["decode_compiles"] == 1
    assert list(reqs[0].generated) == plain[0][0]
    assert list(reqs[2].generated) == plain[2][0]


def test_eos_with_a_launch_in_flight_rolls_back(models):
    """A stream that ends on EOS at commit N had launch N+1 in flight: that
    token is rolled back and the streams equal the unpipelined engine's."""
    _, tm = models
    prompts, cfgs = _mix(seed=66)
    plain, _ = _streams(LLMEngine, tm, prompts, cfgs, n_new=12)
    # a stream and a token it first emits from a decode step (not the
    # prefill), with decode steps left after it
    j, eos = next((j, t) for j, (toks, _) in enumerate(plain)
                  for i, t in enumerate(toks[:8])
                  if i >= 2 and t not in toks[:i])
    runs = []
    for pipelined in (False, True):
        engine = LLMEngine(tm, max_batch_size=4, block_size=4,
                           pipeline_decode=pipelined, device="cpu")
        reqs = [engine.add_request(p, max_new_tokens=12,
                                   eos_token_id=eos if i == j else None, **c)
                for i, (p, c) in enumerate(zip(prompts, cfgs))]
        engine.run()
        runs.append(([list(r.generated) for r in reqs], engine.stats()))
    (plain_eos, _), (piped_eos, st) = runs
    assert piped_eos == plain_eos
    assert plain_eos[j][-1] == eos and len(plain_eos[j]) < 12
    assert st["commit_rollbacks"] >= 1


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_churn_and_eviction_keep_the_streams(models, kv_dtype):
    jm, tm = models
    first = [_prompt(n, seed=57) for n in (11, 12, 5)]
    later = [_prompt(n, seed=58) for n in (10, 4, 7)]
    cfgs = [dict(SAMPLERS[i % len(SAMPLERS)]) for i in range(6)]

    def run(engine):
        reqs = [engine.add_request(p, max_new_tokens=10, **c)
                for p, c in zip(first, cfgs)]
        for _ in range(3):
            engine.step()
        reqs += [engine.add_request(p, max_new_tokens=10, **c)
                 for p, c in zip(later, cfgs[3:])]
        engine.run()
        assert all(r.state == FINISHED for r in reqs)
        return [list(r.generated) for r in reqs]

    want = run(JLLMEngine(jm, kv_dtype=kv_dtype, **TIGHT))
    plain = run(LLMEngine(tm, device="cpu", kv_dtype=kv_dtype, **TIGHT))
    engine = LLMEngine(tm, device="cpu", kv_dtype=kv_dtype,
                       pipeline_decode=True, **TIGHT)
    piped = run(engine)
    assert plain == want
    assert piped == want
    st = engine.stats()
    assert st["evictions"] >= 1 and st["decode_compiles"] == 1


def test_each_launch_keeps_its_own_host_buffers(models):
    """Launch N+1 writes neither the staging buffer launch N copied from nor
    the output buffer launch N's commit reads: every commit reads exactly
    what its launch produced."""
    _, tm = models
    prompts, cfgs = _mix(seed=67)
    engine = LLMEngine(tm, max_batch_size=4, block_size=4,
                       pipeline_decode=True, device="cpu")
    for p, c in zip(prompts, cfgs):
        engine.add_request(p, max_new_tokens=8, **c)
    produced, read, turns = {}, [], []

    def launch(active, orig=engine._launch):
        out = orig(active)
        # keyed by the record, alive until its commit
        produced[id(out)] = [v.copy() for v in out[0]]
        staged = engine._staging[(engine._launches - 1) % 2]
        turns.append((staged[0].data_ptr(), out[0][0].ctypes.data))
        return out

    def read_outputs(out, orig=engine._read_outputs):
        got = orig(out)
        read.append(all(np.array_equal(a, b)
                        for a, b in zip(got, produced[id(out)])))
        return got

    engine._launch = launch
    engine._read_outputs = read_outputs
    engine.run()
    assert len(read) == len(turns) >= 8 and all(read)
    # staging and output buffers both alternate
    assert all(a[0] != b[0] and a[1] != b[1]
               for a, b in zip(turns, turns[1:]))
    assert len(set(turns)) == 2


@pytest.mark.parametrize("pipeline", [False, True])
def test_greedy_only_steps_take_the_greedy_head(models, pipeline):
    """A step in which no launched slot samples runs the greedy head (no
    processors' sort): streams, logprobs included, equal those of an
    engine that runs the full head every step, and both heads run under
    the one build."""
    _, tm = models
    prompts = [_prompt(n, seed=73) for n in (9, 6, 11, 7)]
    cfgs = [{}, dict(SAMPLERS[4]), {}, dict(SAMPLERS[2])]
    news = (10, 3, 10, 4)             # the sampled streams finish first
    runs, heads = [], []
    for always_full in (False, True):
        engine = LLMEngine(tm, max_batch_size=4, block_size=4,
                           pipeline_decode=pipeline, device="cpu")
        if always_full:
            engine._samples = lambda active: True
        else:
            def samples(active, orig=engine._samples):
                heads.append(orig(active))
                return heads[-1]
            engine._samples = samples
        reqs = [engine.add_request(p, max_new_tokens=n, **c)
                for p, c, n in zip(prompts, cfgs, news)]
        engine.run()
        assert engine.stats()["decode_compiles"] == 1
        assert engine.stats()["commit_rollbacks"] == 0
        runs.append([(list(r.generated), list(r.token_logprobs))
                     for r in reqs])
    assert runs[0] == runs[1]
    assert True in heads and False in heads
    assert heads.index(False) > heads.index(True)


class _CallbackError(RuntimeError):
    pass


def _raising_runs(tm, kv_dtype, raise_on, first=None, eos=None):
    """Both engines (unpipelined, then pipelined) over 4 slots and 4
    requests of 8 tokens, 2 of them sampled, where request 0's callback
    raises once, on the token `raise_on(req, tok)` picks (never when
    None), and the caller catches it and keeps stepping (at most 64
    steps: a stream that never retires fails the run). Request 0 stops at
    `eos`; it is greedy, or samples with `first`'s config (the sampled
    pair is then requests 0 and 3). Returns each engine's streams
    (tokens and logprobs) and stats."""
    prompts = [_prompt(n, seed=75) for n in (9, 6, 11, 7)]
    cfgs = [dict(first or {}, eos_token_id=eos),
            {} if first else dict(SAMPLERS[4]), {}, dict(SAMPLERS[3])]
    runs = []
    for pipelined in (False, True):
        engine = LLMEngine(tm, max_batch_size=4, block_size=4,
                           kv_dtype=kv_dtype, pipeline_decode=pipelined,
                           device="cpu")
        raised = []

        def on_token(req, tok, text):
            if not raised and raise_on is not None \
                    and raise_on(req, tok):
                raised.append(tok)
                raise _CallbackError("callback failed")

        reqs = [engine.add_request(p, max_new_tokens=8,
                                   on_token=on_token if i == 0 else None,
                                   **c)
                for i, (p, c) in enumerate(zip(prompts, cfgs))]
        caught = 0
        for _ in range(64):
            try:
                if not engine.step():
                    break
            except _CallbackError:
                caught += 1
        else:
            raise AssertionError(f"pipelined={pipelined}: still stepping "
                                 f"after 64 steps, states "
                                 f"{[r.state for r in reqs]}")
        assert caught == len(raised) == (raise_on is not None)
        assert all(r.state == FINISHED for r in reqs)
        runs.append(([(list(r.generated), list(r.token_logprobs))
                      for r in reqs], engine.stats()))
    return runs


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_raising_callback_loses_no_token(models, kv_dtype):
    """4 slots, 4 requests of 8 tokens (2 sampled). The callback of the
    request committed first raises once, at its third token (a decode
    step's commit, with the records of the other slots after it); the
    caller catches it and keeps stepping. Every stream, logprobs
    included, equals the unpipelined engine's under the same raise, and
    no token is rolled back."""
    (plain, _), (piped, st) = _raising_runs(
        models[1], kv_dtype, lambda req, tok: len(req.generated) == 3)
    assert st["commit_rollbacks"] == 0 and st["decode_compiles"] == 1
    assert piped == plain
    assert all(len(toks) == 8 for toks, _ in piped)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("last", ["max_new_tokens", "eos"])
def test_raising_callback_on_the_last_token_retires_the_stream(
        models, kv_dtype, last):
    """The callback raises on request 0's last token: its 8th (the
    max_new_tokens cut) or its EOS (a token it draws at a decode step
    when nothing stops it, which stops it there); it samples, so its
    stream does not repeat one token. Both engines still
    retire the request on that token, none runs past it, and the
    pipelined streams equal the unpipelined ones. Each engine rolls back
    as many tokens as it does without the raise."""
    tm = models[1]
    first = dict(SAMPLERS[4])
    eos, n = None, 8
    if last == "eos":
        (free, _), _ = _raising_runs(tm, kv_dtype, None, first)
        toks = free[0][0]
        # the first token whose first draw is a decode step's (index >= 3)
        eos = next(t for i, t in enumerate(toks) if i >= 3
                   and toks.index(t) == i)
        n = toks.index(eos) + 1
    (_, _), (_, calm) = _raising_runs(tm, kv_dtype, None, first, eos)
    (plain, _), (piped, st) = _raising_runs(
        tm, kv_dtype, lambda req, tok: len(req.generated) == n, first, eos)
    assert piped == plain
    assert len(piped[0][0]) == n
    assert st["commit_rollbacks"] == calm["commit_rollbacks"]
    assert st["decode_compiles"] == 1


def test_pipelined_engine_defaults_to_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(models[1], pipeline_decode=True)
