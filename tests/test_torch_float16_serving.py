"""Port parity: float16 serving, and the attention-kernel switch, vs the
JAX engine.

A tiny GPT (2 layers, hidden 64, 4 heads of 16) made by the JAX package
from a seed, its weights carried across (`load_jax_state`), then both
models cast to float16 (`half()` / ``.to(torch.float16)``: the same
round-to-nearest of the same fp32 values):

  * teacher-forced logits: the port's f16 forward over the port engine's
    greedy streams against the JAX f16 forward, within LOGIT_ATOL; the
    streams equal the JAX engine's wherever the JAX top-two margin exceeds
    twice that (every step here);
  * the f16 model over float16 pools (its own), int8 pools, fp32 and bf16
    pools, and a bf16 model over float16 pools: greedy streams equal the
    JAX engine's with the same ``kv_dtype``;
  * `generate` in f16 equals the JAX `generate`;
  * two tenants' adapters through the f16 engine: streams equal the JAX
    engine's;
  * crash-resume: an f16 engine's `state_payload` restored into a fresh
    engine continues the streams token for token;
  * ``attention_kernel=``: "pallas", "blockwise" and "reference" each serve
    the JAX engine's streams under the same name (fp32 and int8 pools),
    ``FLAGS_serve_attention_kernel`` is the default, the name is reported
    in `stats()`, and an unknown name raises ValueError.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import LLMEngine as JLLMEngine

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework import get_flags, set_flags
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn.functional.attention import (PAGED_KERNELS,
                                                      resolve_paged_kernel)
from paddle_tpu_torch.serving import LLMEngine

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 128
CFG = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0, initializer_range=0.3)
ENGINE = dict(max_batch_size=2, block_size=4)
# f16 logits of up to ~10: the two forwards round each op's f16 output in
# other places (XLA fuses, PyTorch rounds op by op), a few f16 steps of
# 2^-7 at 8-16 (0.013 seen)
LOGIT_ATOL = 4 * 2.0 ** -7
_J = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
      torch.float16: jnp.float16, "int8": "int8"}


def _pair(dtype=torch.float16):
    paddle.seed(0)
    jm = JGPTForCausalLM(JGPTConfig(**CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    jm.to(dtype=str(dtype).replace("torch.", ""))
    tm.to(dtype)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


def _prompt(length, seed=0):
    rng = np.random.default_rng(seed * 1000 + length)
    return rng.integers(0, VOCAB, length).tolist()


def _streams(engine, prompts, new=7, **kw):
    reqs = [engine.add_request(p, max_new_tokens=new, **kw) for p in prompts]
    engine.run()
    return [list(r.generated) for r in reqs]


def _both(models, prompts, kv_dtype=None, **kw):
    jm, tm = models
    je = JLLMEngine(jm, kv_dtype=_J.get(kv_dtype, kv_dtype), **ENGINE, **kw)
    te = LLMEngine(tm, device="cpu", kv_dtype=kv_dtype, **ENGINE, **kw)
    return _streams(je, prompts), _streams(te, prompts), je, te


def test_f16_engine_teacher_forced_logits_and_streams_match_jax(models):
    jm, tm = models
    prompts = [_prompt(n, seed=1) for n in (9, 6, 11)]
    want, got, _, te = _both(models, prompts)
    assert te.cache.k_pools.dtype == torch.float16
    assert te.stats()["kv_dtype"] == "float16"
    for prompt, stream, j_stream in zip(prompts, got, want):
        ids = np.asarray([prompt + stream], np.int64)
        j_logits = np.asarray(jm(paddle.Tensor(ids))._value
                              .astype(jnp.float32))[0]
        out = tm(torch.from_numpy(ids))
        t_logits = (out[0] if isinstance(out, tuple) else out)[0]
        assert t_logits.dtype == torch.float16
        np.testing.assert_allclose(t_logits.float().detach().numpy(),
                                   j_logits, rtol=0, atol=LOGIT_ATOL)
        top2 = np.sort(j_logits, -1)[:, -2:]
        for step, token in enumerate(stream):
            at = len(prompt) - 1 + step
            if top2[at, 1] - top2[at, 0] <= 2 * LOGIT_ATOL:
                break
            assert token == int(j_logits[at].argmax())
            assert token == j_stream[step]


@pytest.mark.parametrize("kv_dtype", ["int8", torch.float32, torch.bfloat16])
def test_f16_model_over_other_pools_matches_jax(models, kv_dtype):
    prompts = [_prompt(n, seed=2) for n in (8, 5, 12)]
    want, got, _, te = _both(models, prompts, kv_dtype=kv_dtype)
    assert got == want
    assert te.cache.k_pools.dtype == (torch.int8 if kv_dtype == "int8"
                                      else kv_dtype)


def _agree_while_decided(models, prompts, got, want, atol):
    """The port's teacher-forced logits over each JAX stream within `atol`
    of the JAX model's, and each port stream equal to the JAX engine's up
    to the first step whose JAX top-two margin is within 2 atol (where the
    two packages' roundings may pick either token)."""
    jm, tm = models
    for prompt, g, w in zip(prompts, got, want):
        ids = np.asarray([prompt + w], np.int64)
        logits = np.asarray(jm(paddle.Tensor(ids))._value
                            .astype(jnp.float32))[0]
        out = tm(torch.from_numpy(ids))
        t_logits = (out[0] if isinstance(out, tuple) else out)[0]
        np.testing.assert_allclose(t_logits.float().detach().numpy(),
                                   logits, rtol=0, atol=atol)
        top2 = np.sort(logits, -1)[:, -2:]
        margins = top2[len(prompt) - 1:-1, 1] - top2[len(prompt) - 1:-1, 0]
        close = np.flatnonzero(margins <= 2 * atol)
        decided = int(close[0]) if close.size else len(w)
        assert g[:decided] == w[:decided], (g, w, margins)


def test_bf16_model_over_f16_pools_matches_jax():
    """A bf16 model over f16 pools: teacher-forced logits within 4 bf16
    steps of 2^-4 (logits of 8-16; 0.11 seen), streams equal while
    decided."""
    prompts = [_prompt(n, seed=3) for n in (7, 10)]
    models = _pair(torch.bfloat16)
    want, got, _, te = _both(models, prompts, kv_dtype=torch.float16)
    assert te.cache.k_pools.dtype == torch.float16
    _agree_while_decided(models, prompts, got, want, 4 * 2.0 ** -4)


def test_f16_generate_matches_jax(models):
    jm, tm = models
    ids = np.random.default_rng(4).integers(0, VOCAB, (3, 7)) \
        .astype(np.int64)
    want = np.asarray(jm.generate(paddle.Tensor(ids),
                                  max_new_tokens=8)._value)
    got = tm.generate(ids, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_f16_tenancy_two_adapters_matches_jax(models):
    jm, tm = models
    kw = dict(max_batch_size=3, block_size=4, num_blocks=64, max_adapters=3,
              adapter_rank=2)
    je, te = JLLMEngine(jm, **kw), LLMEngine(tm, device="cpu", **kw)
    for engine in (je, te):
        engine.register_adapter("t1", seed=1, scale=25.0)
        engine.register_adapter("t2", seed=2, scale=25.0)
    prompts = [_prompt(n, seed=5) for n in (9, 6, 11, 7)]
    plan = ["t1", None, "t2", "t1"]
    streams = []
    for engine in (je, te):
        reqs = [engine.add_request(p, max_new_tokens=5, adapter=ad)
                for p, ad in zip(prompts, plan)]
        engine.run()
        streams.append([list(r.generated) for r in reqs])
    assert streams[1] == streams[0]
    assert sorted(te.stats()["adapters"]) == ["t1", "t2"]


def test_f16_crash_resume_continues_the_streams(models):
    _, tm = models
    prompts = [_prompt(n, seed=6) for n in (9, 6, 11)]
    whole = LLMEngine(tm, device="cpu", **ENGINE)
    want = _streams(whole, prompts, new=8)
    first = LLMEngine(tm, device="cpu", **ENGINE)
    reqs = [first.add_request(p, max_new_tokens=8) for p in prompts]
    for _ in range(5):
        first.step()
    payload = first.state_payload()
    fresh = LLMEngine(tm, device="cpu", **ENGINE)
    restored = {r.rid: r for r in fresh.restore_state(payload)}
    fresh.run()
    got = [list(restored[r.rid].generated) if r.rid in restored
           else list(r.generated) for r in reqs]
    assert got == want


# ---------------------------------------------------------------------------
# the attention-kernel switch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fp32_models():
    return _pair(torch.float32)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("name", PAGED_KERNELS)
def test_each_attention_kernel_serves_the_jax_streams(fp32_models, name,
                                                      kv_dtype):
    prompts = [_prompt(n, seed=7) for n in (9, 4, 12)]
    want, got, _, te = _both(fp32_models, prompts, kv_dtype=kv_dtype,
                             attention_kernel=name)
    assert got == want
    assert te.stats()["attention_kernel"] == name


def test_the_flag_names_the_default_and_unknown_names_raise(fp32_models):
    _, tm = fp32_models
    assert get_flags("FLAGS_serve_attention_kernel") == \
        {"FLAGS_serve_attention_kernel": "blockwise"}
    assert LLMEngine(tm, device="cpu", **ENGINE) \
        .stats()["attention_kernel"] == "blockwise"
    set_flags({"FLAGS_serve_attention_kernel": "reference"})
    try:
        assert resolve_paged_kernel() == "reference"
        engine = LLMEngine(tm, device="cpu", **ENGINE)
        assert engine.stats()["attention_kernel"] == "reference"
        # an explicit name wins over the flag
        assert LLMEngine(tm, device="cpu", attention_kernel="pallas",
                         **ENGINE).stats()["attention_kernel"] == "pallas"
    finally:
        set_flags({"FLAGS_serve_attention_kernel": "blockwise"})
    with pytest.raises(ValueError, match="unknown paged attention kernel"):
        LLMEngine(tm, device="cpu", attention_kernel="flash", **ENGINE)
