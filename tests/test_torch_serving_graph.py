"""The port's decode program: one build per engine, run every step.

On the card `LLMEngine` captures its decode forward in one CUDA graph and
replays it; on the CPU the same forward runs over the same static slot
buffers without capture. These tests hold the CPU side:

  * greedy streams equal the JAX engine's under churn (requests joining
    mid-flight and leaving) with a pool small enough to force evictions,
    for fp32 and int8 pools;
  * ``decode_compiles`` is 1 across churn and eviction, 0 after
    `reset_stats()` and for an engine that never decoded (as
    tests/test_serving.py holds the reference's);
  * the static slot buffers (with the sampler config and the override
    mask), the output, history and feedback buffers and the host buffers
    keep their storage across steps and admissions, and the slot buffer
    holds the host mirrors after each step's one copy;
  * `kernels.captured_launches` takes a capture's counts back out and
    `add_launches` adds them once per replay;
  * a sampled stream replays byte for byte after preemption, and the
    eager step (`_decode_step_eager`) gives the program's tokens.

The model is tests/test_torch_serving.py's tiny GPT (vocab 128, hidden
64, one head of 64, two layers).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import LLMEngine as JLLMEngine

from paddle_tpu_torch import kernels
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import LLMEngine
from paddle_tpu_torch.serving.engine import _slot_views

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 128
CFG = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=1, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
# three slots over 10 blocks of 4 tokens (one is the null block), one
# block held back: the growing streams must evict
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


# (prompt lengths joining before the first step, steps, lengths joining
# then): churn over a tight pool
CHURN = ((11, 12, 5), 3, (10, 4, 7))


def _churn(engine, new=10, seed=5):
    """Drive `engine` through CHURN; returns the requests in order."""
    first, steps, later = CHURN
    reqs = [engine.add_request(_prompt(n, seed), max_new_tokens=new)
            for n in first]
    for _ in range(steps):
        engine.step()
    reqs += [engine.add_request(_prompt(n, seed + 1), max_new_tokens=new)
             for n in later]
    engine.run()
    return reqs


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_greedy_streams_match_jax_engine_under_churn_and_eviction(
        models, kv_dtype):
    jm, tm = models
    j_reqs = _churn(JLLMEngine(jm, kv_dtype=kv_dtype, **TIGHT))
    engine = LLMEngine(tm, device="cpu", kv_dtype=kv_dtype, **TIGHT)
    reqs = _churn(engine)
    assert [list(r.generated) for r in reqs] \
        == [list(r.generated) for r in j_reqs]
    st = engine.stats()
    assert st["evictions"] >= 1            # the tight pool actually bit
    assert st["completed"] == len(reqs)
    assert st["decode_compiles"] == 1      # churn and eviction: no rebuild


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_decode_compiles_counts_builds_and_resets(models, kv_dtype):
    _, tm = models
    idle = LLMEngine(tm, device="cpu", kv_dtype=kv_dtype, **TIGHT)
    assert idle.stats()["decode_compiles"] == 0     # never decoded
    engine = LLMEngine(tm, device="cpu", kv_dtype=kv_dtype, **TIGHT)
    _churn(engine)
    assert engine.stats()["decode_compiles"] == 1
    stats = engine._stats
    engine.reset_stats()
    assert engine._stats is stats                   # zeroed in place
    assert engine.stats()["decode_compiles"] == 0
    _churn(engine, seed=9)                          # the program stays
    st = engine.stats()
    assert st["decode_compiles"] == 0 and st["steps"] > 0


def test_static_buffers_keep_storage_and_hold_the_mirrors(models):
    _, tm = models
    engine = LLMEngine(tm, device="cpu", **TIGHT)

    def storage():
        return [engine._slots_dev.data_ptr(), engine._out_dev.data_ptr(),
                engine._history.data_ptr(), engine._feedback.data_ptr()] \
            + [b[0].data_ptr() for b in engine._staging + engine._outputs]

    ptrs = storage()
    views = _slot_views(engine._slots_dev, engine.max_batch_size,
                        engine.max_blocks_per_seq)
    view_ptrs = [v.data_ptr() for v in views]
    first, steps, later = CHURN
    for n in first:
        engine.add_request(_prompt(n), max_new_tokens=10)
    seen = 0
    for i in range(steps + 6):
        if i == steps:
            for n in later:
                engine.add_request(_prompt(n, 1), max_new_tokens=10)
        mirrors = None

        def snapshot(active, orig=engine._launch):
            out = orig(active)
            nonlocal mirrors
            mirrors = [engine._tokens.copy(), engine._tables.copy(),
                       engine._lens.copy(), active.copy(),
                       engine._temps.copy(), engine._topks.copy(),
                       engine._topps.copy(), engine._rpens.copy(),
                       engine._seeds.view(np.int32).copy(),
                       engine._override.copy(), engine._aslots.copy()]
            return out

        engine._launch = snapshot
        engine.step()
        del engine._launch
        assert storage() == ptrs
        assert [v.data_ptr() for v in views] == view_ptrs
        if mirrors is not None:
            seen += 1
            for view, mirror in zip(views, mirrors, strict=True):
                np.testing.assert_array_equal(view.numpy(), mirror)
    assert seen >= steps + 3
    assert engine.stats()["decode_compiles"] == 1


@pytest.mark.parametrize("replays", [0, 1, 3])
def test_captured_launches_count_once_per_replay(replays):
    """A capture's wrappers count launches that only run at each replay:
    `captured_launches` takes them back out and returns them, and each
    `add_launches(record)` adds them once."""
    kernels.reset_launch_counts()
    mods = {"paged_decode_append": kernels.paged_attention,
            "fused_ln": kernels.fused_ln}
    mods["fused_ln"].launches["fused_ln"] = 5        # launched eagerly

    def capture():
        for name, mod in mods.items():
            mod.launches[name] += 2                  # 2 layers, captured
        return "graph"

    out, record = kernels.captured_launches(capture)
    assert out == "graph"
    assert record == {"paged_decode_append": 2, "fused_ln": 2}
    assert kernels.launch_counts()["paged_decode_append"] == 0
    assert kernels.launch_counts()["fused_ln"] == 5
    for _ in range(replays):
        kernels.add_launches(record)
    counts = kernels.launch_counts()
    assert counts["paged_decode_append"] == 2 * replays
    assert counts["fused_ln"] == 5 + 2 * replays
    assert all(n == 0 for name, n in counts.items()
               if name not in record)
    kernels.reset_launch_counts()


def test_sampled_stream_replays_after_preemption(models):
    """Sampled streams in a tight pool (evicted and re-prefilled) draw
    the same tokens as in a roomy pool that never evicts."""
    _, tm = models
    prompts = [_prompt(n, seed=57) for n in (11, 12, 10, 5)]
    cfgs = [dict(temperature=0.9, top_k=16, top_p=0.9, seed=2000 + i)
            for i in range(4)]

    def run(**kw):
        engine = LLMEngine(tm, device="cpu", **kw)
        reqs = [engine.add_request(p, max_new_tokens=10, **c)
                for p, c in zip(prompts, cfgs)]
        engine.run()
        return engine, [(list(r.generated), list(r.token_logprobs))
                        for r in reqs]

    _, roomy = run(max_batch_size=3, block_size=4)
    tight_engine, tight = run(**TIGHT)
    assert tight_engine.stats()["evictions"] >= 1
    assert tight_engine.stats()["decode_compiles"] == 1
    assert [g for g, _ in tight] == [g for g, _ in roomy]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_eager_step_gives_the_programs_tokens(models, kv_dtype):
    """`_decode_step_eager` (fresh copies and views, no program) and the
    program decode the same tokens, and the eager engine builds nothing."""
    _, tm = models
    program = LLMEngine(tm, device="cpu", kv_dtype=kv_dtype, **TIGHT)
    eager = LLMEngine(tm, device="cpu", kv_dtype=kv_dtype, **TIGHT)
    eager._decode_step = eager._decode_step_eager
    a, b = _churn(program), _churn(eager)
    assert [list(r.generated) for r in a] == [list(r.generated) for r in b]
    assert eager.stats()["decode_compiles"] == 0
    assert program.stats()["decode_compiles"] == 1
