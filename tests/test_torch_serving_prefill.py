"""The port's prefill programs: one build per bucket, run for every prompt.

On the card `LLMEngine` captures each prefill bucket's program (forward,
K/V scatter, last real row's logits, history row) in a CUDA graph at the
bucket's first prompt, and two sampler heads once; on the CPU the same
code runs over the same static buffers without capture. These tests hold
the CPU side:

  * ``prefill_compiles`` equals the JAX engine's on 64 streams of mixed
    lengths through 8 slots (tests/test_serving.py's zero-retrace case),
    is 0 after `reset_stats()` over the same buckets and 1 for a new one;
  * greedy and sampled streams equal the JAX engine's (unpipelined) token
    for token, with fp32 and int8 pools, the port pipelined and not,
    through eviction and resume;
  * the program writes the prompt into the slot's history row (zeros
    past it), where the decode steps then append;
  * building a bucket while another stream is mid-decode leaves that
    stream's blocks, history row and tokens as they were (the warm-up
    writes an all-null block row and the spare history row);
  * the static prefill buffers keep their storage across prefills, and
    the heads are built once;
  * the prefill head over the ``[1, max_context]`` ids row gives the
    bucket-width head's token and logprobs bit for bit;
  * the eager prefill (`_prefill_eager`) gives the program's streams and
    pools and builds nothing;
  * `PagedKVCache` without a device raises here, as the engine does.

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

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import LLMEngine, PagedKVCache
from paddle_tpu_torch.serving.sampling import sample_tokens

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


def _engine(tm, **kw):
    return LLMEngine(tm, device="cpu", **kw)


def _pools(engine):
    """Copies of the engine's pools (and int8 scales)."""
    cache = engine.cache
    return [t.clone() for t in (cache.k_pools, cache.v_pools, cache.k_scales,
                                cache.v_scales) if t is not None]


def test_paged_kv_cache_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(2, 3, 8, 5, 4)
    assert PagedKVCache(2, 3, 8, 5, 4, device="cpu").k_pools.device.type \
        == "cpu"


# the zero-retrace case of tests/test_serving.py: 64 streams of these
# lengths through 8 slots cover the buckets 8, 16 and 32
LENGTHS = (3, 5, 8, 11, 16, 21)


def _sixty_four(engine, seed=7, new=6):
    uniques = {n: _prompt(n, seed=seed) for n in LENGTHS}
    prompts = [uniques[LENGTHS[i % len(LENGTHS)]] for i in range(64)]
    return engine.generate(prompts, max_new_tokens=new)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefill_compiles_equal_the_jax_engines_and_reset(models, kv_dtype):
    jm, tm = models
    j_engine = JLLMEngine(jm, max_batch_size=8, block_size=4,
                          kv_dtype=kv_dtype)
    j_outs = _sixty_four(j_engine)
    engine = _engine(tm, max_batch_size=8, block_size=4, kv_dtype=kv_dtype)
    outs = _sixty_four(engine)
    assert outs == j_outs
    st = engine.stats()
    assert st["prefill_compiles"] == j_engine.stats()["prefill_compiles"] \
        == 3                                   # buckets 8, 16, 32
    assert st["prefills"] == 64 and st["decode_compiles"] == 1
    assert sorted(engine._prefill_fns) == [8, 16, 32]
    engine.reset_stats()
    assert engine.stats()["prefill_compiles"] == 0
    assert _sixty_four(engine, seed=8) == _sixty_four(
        _engine(tm, max_batch_size=8, block_size=4, kv_dtype=kv_dtype),
        seed=8)
    assert engine.stats()["prefill_compiles"] == 0   # every bucket built
    engine.generate([_prompt(40)], max_new_tokens=3)
    st = engine.stats()
    assert st["prefill_compiles"] == 1 and st["decode_compiles"] == 0
    assert sorted(engine._prefill_fns) == [8, 16, 32, 64]


def _streams(engine, prompts, cfgs, new=8):
    reqs = [engine.add_request(p, max_new_tokens=new, **c)
            for p, c in zip(prompts, cfgs)]
    engine.run()
    return [(list(r.generated), list(r.token_logprobs)) for r in reqs]


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_streams_equal_the_jax_engine_through_eviction(models, kv_dtype,
                                                       pipelined):
    jm, tm = models
    prompts = [_prompt(n, seed=81) for n in (11, 12, 10, 5, 9)]
    cfgs = [dict(SAMPLERS[i % len(SAMPLERS)]) for i in range(len(prompts))]
    want = _streams(JLLMEngine(jm, kv_dtype=kv_dtype, **TIGHT), prompts,
                    cfgs, new=10)
    engine = _engine(tm, kv_dtype=kv_dtype, pipeline_decode=pipelined,
                     **TIGHT)
    got = _streams(engine, prompts, cfgs, new=10)
    assert [t for t, _ in got] == [t for t, _ in want]
    # logprobs: float32 log-softmax of each package's own logits. A
    # pipelined eviction rolls the victim's in-flight token back, so it
    # resumes with one token less in its re-prefill and decodes that one
    # again: with int8 pools the block then holds another quantization of
    # the same values (the prefill's per-block amax, not the decode's
    # requantization), and only the tokens are the reference's
    if not (pipelined and kv_dtype):
        np.testing.assert_allclose(
            np.array([lp for _, lps in got for lp in lps]),
            np.array([lp for _, lps in want for lp in lps]), rtol=0,
            atol=1e-4)
    st = engine.stats()
    assert st["evictions"] >= 1                 # resumes re-prefill
    assert st["prefills"] == len(prompts) + st["evictions"]
    assert st["prefill_compiles"] == len(engine._prefill_fns)
    assert st["decode_compiles"] == 1 and st["sampled_tokens"] > 0


def test_prefill_writes_the_slots_history_row(models):
    """The program writes the prompt into its slot's history row (zeros
    past it), through the device slot index, whatever the bucket; the
    decode steps then append at ``lens``."""
    _, tm = models
    engine = _engine(tm, max_batch_size=3, block_size=4)
    reqs = [engine.add_request(_prompt(n, seed=11), max_new_tokens=3)
            for n in (5, 13, 30)]
    engine.step()                                # three prefills, a step
    for req in reqs:
        row = engine._history[req.slot].tolist()
        n = len(req.prompt)
        assert row[:n] == req.prompt
        assert row[n] == req.generated[0]        # the step's input token
        assert row[n + 1:] == [0] * (engine.max_context - n - 1)
    assert sorted(engine._prefill_fns) == [8, 16, 32]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_bucket_build_mid_decode_leaves_the_live_stream(models, kv_dtype):
    _, tm = models
    prompt, cfg = _prompt(11, seed=3), dict(temperature=0.8, top_k=20,
                                            seed=77)
    solo = _engine(tm, max_batch_size=3, block_size=4, kv_dtype=kv_dtype)
    (want, _), = _streams(solo, [prompt], [cfg], new=12)

    engine = _engine(tm, max_batch_size=3, block_size=4, kv_dtype=kv_dtype)
    req = engine.add_request(prompt, max_new_tokens=12, **cfg)
    for _ in range(4):
        engine.step()
    blocks = list(req.blocks)
    pools = [p[:, blocks].clone() for p in _pools(engine)]
    history = engine._history[req.slot].clone()
    assert 64 not in engine._prefill_fns
    engine._build_prefill(64)                    # a new bucket, mid-decode
    assert engine.stats()["prefill_compiles"] == 2
    for before, after in zip(pools, _pools(engine)):
        assert torch.equal(before, after[:, blocks])
    assert torch.equal(history, engine._history[req.slot])
    # a prompt that lands in another new bucket, admitted mid-decode
    other = engine.add_request(_prompt(20, seed=4), max_new_tokens=4)
    engine.run()
    assert engine.stats()["prefill_compiles"] == 3
    assert req.generated == want and len(other.generated) == 4


def test_static_prefill_buffers_keep_storage(models):
    _, tm = models
    engine = _engine(tm, max_batch_size=3, block_size=4, logprobs_topk=2)

    def storage():
        bufs = [engine._pf_dev, engine._pf_host, engine._pf_logits,
                engine._pf_filtered, engine._pf_out_dev, engine._pf_out_host,
                engine._history_rows, *engine._pf_views,
                *engine._pf_out_views]
        return [b.data_ptr() for b in bufs] \
            + [a.ctypes.data for a in engine._pf_staged + engine._pf_outputs]

    ptrs = storage()
    for i, n in enumerate((3, 11, 20, 9, 40, 6)):
        engine.add_request(_prompt(n, seed=9), max_new_tokens=3,
                           **SAMPLERS[i % len(SAMPLERS)])
        engine.step()
        if i == 0:
            heads = engine._prefill_heads
        assert engine._prefill_heads is heads     # built once
        assert storage() == ptrs
    engine.run()
    assert storage() == ptrs
    assert sorted(engine._prefill_fns) == [8, 16, 32, 64]


@pytest.mark.parametrize("cfg", SAMPLERS)
@pytest.mark.parametrize("length", [1, 7, 8, 13, 32])
def test_prefill_head_over_the_full_row_equals_the_bucket_head(models, cfg,
                                                              length):
    _, tm = models
    engine = _engine(tm, max_batch_size=2, block_size=4, logprobs_topk=3)
    bucket = engine._bucket_for(length)
    rng = np.random.default_rng(length)
    ids = rng.integers(0, VOCAB, length).tolist()
    logits = torch.from_numpy(rng.standard_normal((1, VOCAB))
                              .astype(np.float32) * 3)
    req = {**dict(temperature=0.0, top_k=0, top_p=1.0,
                  repetition_penalty=1.0, seed=0), **cfg}
    engine._stage_prefill(ids, np.zeros(engine.max_blocks_per_seq,
                                        np.int32), 1, req["temperature"],
                          req["top_k"], req["top_p"],
                          req["repetition_penalty"], req["seed"])
    engine._pf_logits.copy_(logits)
    sampled = req["temperature"] > 0
    engine._prefill_head(sampled)
    got = [v.clone() for v in engine._pf_out_views]
    # the eager prefill's head: history and validity at the bucket's width
    history = torch.zeros((1, bucket), dtype=torch.int32)
    history[0, :length] = torch.tensor(ids)
    seed = int(np.uint32(req["seed"]).view(np.int32))
    want = sample_tokens(
        logits, torch.tensor([req["temperature"]]),
        torch.tensor([req["top_k"]], dtype=torch.int32),
        torch.tensor([req["top_p"]]),
        torch.tensor([req["repetition_penalty"]]),
        torch.tensor([seed], dtype=torch.int32),
        torch.tensor([length], dtype=torch.int32), history,
        (torch.arange(bucket) < length)[None, :], logprobs_topk=3,
        greedy_only=not sampled)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g, w)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_eager_prefill_gives_the_programs_streams_and_pools(models,
                                                            kv_dtype):
    _, tm = models
    prompts = [_prompt(n, seed=82) for n in (11, 12, 10, 5, 9)]
    cfgs = [dict(SAMPLERS[i % len(SAMPLERS)]) for i in range(len(prompts))]
    program = _engine(tm, kv_dtype=kv_dtype, **TIGHT)
    eager = _engine(tm, kv_dtype=kv_dtype, **TIGHT)
    eager._prefill = eager._prefill_eager
    assert _streams(program, prompts, cfgs) == _streams(eager, prompts, cfgs)
    for a, b in zip(_pools(program), _pools(eager)):
        assert torch.equal(a[:, 1:], b[:, 1:])
    assert eager.stats()["prefill_compiles"] == 0
    assert program.stats()["prefill_compiles"] == len(program._prefill_fns) \
        > 0
    assert program.stats()["evictions"] >= 1
