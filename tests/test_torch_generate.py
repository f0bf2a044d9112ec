"""Port parity: the static-cache decode, `generate` and `GPTDecodeStep`.

`paddle_tpu/incubate/models/gpt.py` `_decode_step` (:133), `generate`
(:390) and `GPTDecodeStep` (:508) against the port on the same weights:

  * `generate`, greedy and sampled (temperature, top-k, top-p and their
    mixes, other seeds), returns the JAX `generate`'s tokens; its sampled
    draw is `jax.random.categorical` over ``[B, V]`` under one key, which
    the keyed draw's twin repeats with ``row_stride=V`` (bit for bit,
    checked here on the noise itself);
  * the static-cache step at n = 1 and n = 3 (a chunk, causal within it)
    and `GPTDecodeStep`: logits and written buffers within fp32 summation
    order (2e-5; the buffers' other positions untouched, bit for bit);
  * one program build per signature ``(B, P, N, do_sample, top_k, top_p,
    temperature)``: a repeat call, another seed or other prompts of the
    same shape reuse it, as the reference's one trace a signature.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTDecodeStep as JGPTDecodeStep
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.incubate.models import (GPTConfig, GPTDecodeStep,
                                              GPTForCausalLM)
from paddle_tpu_torch.incubate.models.gpt import GEN_CACHE_SIZE
from paddle_tpu_torch.kernels import keyed_draw as kd

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 128
CFG = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0, initializer_range=0.3)
# fp32 logits and K/V of the same arithmetic summed in another order
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPTForCausalLM(JGPTConfig(**CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    return jm, tm


def _ids(b, p, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, p)) \
        .astype(np.int64)


def _jax_generate(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.Tensor(ids), **kw)._value)


SIGNATURES = {
    "greedy": dict(max_new_tokens=9),
    "top_k": dict(max_new_tokens=8, do_sample=True, top_k=6,
                  temperature=0.9, seed=3),
    "top_p": dict(max_new_tokens=8, do_sample=True, top_k=0, top_p=0.8,
                  temperature=1.2, seed=4),
    "top_k_top_p": dict(max_new_tokens=7, do_sample=True, top_k=12,
                        top_p=0.7, temperature=0.7, seed=5),
    "plain_sample": dict(max_new_tokens=6, do_sample=True, top_k=0,
                         seed=2 ** 32 - 1),
}


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_generate_equals_the_jax_generate(models, name):
    jm, tm = models
    kw = SIGNATURES[name]
    ids = _ids(3, 7, seed=len(name))
    want = _jax_generate(jm, ids, **kw)
    got = tm.generate(ids, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_is_not_greedy(models):
    """The sampled signatures above draw: their tokens leave the greedy
    stream (else the comparison would not test the draw)."""
    _, tm = models
    ids = _ids(3, 7, seed=1)
    greedy = tm.generate(ids, max_new_tokens=8).numpy()
    sampled = tm.generate(ids, max_new_tokens=8, do_sample=True, top_k=0,
                          temperature=1.5, seed=9).numpy()
    assert (greedy != sampled).any()


def test_one_build_per_signature(models):
    jm, tm = models
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    tm.generate(_ids(2, 5, seed=1), max_new_tokens=4)
    assert tm.gen_builds == 1
    tm.generate(_ids(2, 5, seed=2), max_new_tokens=4)     # same signature
    tm.generate(_ids(2, 5, seed=1), max_new_tokens=4)
    assert tm.gen_builds == 1
    kw = dict(max_new_tokens=4, do_sample=True, top_k=3, temperature=0.8)
    a = tm.generate(_ids(2, 5, seed=1), seed=1, **kw)
    b = tm.generate(_ids(2, 5, seed=1), seed=1, **kw)     # the seed is a value
    c = tm.generate(_ids(2, 5, seed=1), seed=7, **kw)
    assert tm.gen_builds == 2
    assert torch.equal(a, b)
    np.testing.assert_array_equal(
        c.numpy(), _jax_generate(jm, _ids(2, 5, seed=1), seed=7, **kw))
    tm.generate(_ids(2, 6, seed=1), max_new_tokens=4)     # another P
    tm.generate(_ids(2, 5, seed=1), max_new_tokens=5)     # another N
    assert tm.gen_builds == 4


def test_generate_keeps_the_last_signatures_only(models):
    """Past GEN_CACHE_SIZE signatures the least recently used program goes
    (with its static buffers); used again, it is built again, counted, and
    gives the same tokens."""
    jm, tm = models
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    ids = _ids(2, 5, seed=3)
    first = tm.generate(ids, max_new_tokens=2)
    for n in range(3, 3 + GEN_CACHE_SIZE):
        tm.generate(ids, max_new_tokens=n)
    assert tm.gen_builds == 1 + GEN_CACHE_SIZE
    assert len(tm._gen_cache) == GEN_CACHE_SIZE
    tm.generate(ids, max_new_tokens=2 + GEN_CACHE_SIZE)    # the newest
    assert tm.gen_builds == 1 + GEN_CACHE_SIZE
    assert torch.equal(tm.generate(ids, max_new_tokens=2), first)
    assert tm.gen_builds == 2 + GEN_CACHE_SIZE
    assert len(tm._gen_cache) == GEN_CACHE_SIZE


def test_keyed_draw_rows_equal_a_batch_categorical():
    """``row_stride=V`` draws row b at counters b V + v: the Gumbel noise
    of `jax.random.categorical(key, logits [B, V])`, bit for bit, and its
    tokens."""
    b, v, seed, step = 3, 200, 1234, 5
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    want_noise = np.asarray(jax.random.gumbel(key, (b, v), jnp.float32))
    seeds = torch.full((b,), seed, dtype=torch.int32)
    pos = torch.full((b,), step, dtype=torch.int32)
    noise = kd.gumbel(seeds, pos, v, row_stride=v)
    np.testing.assert_array_equal(noise.numpy(), want_noise)
    logits = np.random.default_rng(0).standard_normal((b, v)) \
        .astype(np.float32)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits),
                                             axis=-1))
    lg = torch.from_numpy(logits)
    got = kd.keyed_draw(lg, lg, torch.ones(b), seeds, pos, row_stride=v)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the static-cache step and GPTDecodeStep
# ---------------------------------------------------------------------------

def _bufs(seed, b=2, t=12):
    rng = np.random.default_rng(seed)
    shape = (CFG["num_hidden_layers"], b, t, CFG["num_attention_heads"],
             CFG["hidden_size"] // CFG["num_attention_heads"])
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("n, pos", [(1, 0), (1, 6), (3, 4), (3, 9)])
def test_static_cache_step_matches_jax(models, n, pos):
    """A chunk of n tokens at `pos`: the logits, and each layer's buffers
    written at pos .. pos + n - 1 and untouched elsewhere."""
    jm, tm = models
    k, v = _bufs(seed=n + pos)
    ids = _ids(2, n, seed=pos)
    j_caches = [(paddle.Tensor(k[l]), paddle.Tensor(v[l]),
                 paddle.Tensor(np.asarray(pos, np.int32)))
                for l in range(k.shape[0])]
    j_logits, j_new = jm(paddle.Tensor(ids), caches=j_caches)
    t_caches = [(torch.from_numpy(k[l].copy()), torch.from_numpy(v[l].copy()),
                 torch.tensor(pos)) for l in range(k.shape[0])]
    with torch.no_grad():
        t_logits, t_new = tm(torch.from_numpy(ids), caches=t_caches)
    np.testing.assert_allclose(t_logits.numpy(),
                               np.asarray(j_logits._value), **TOL)
    rows = slice(pos, pos + n)
    for l, ((tk, tv, _), (jk, jv, _)) in enumerate(zip(t_new, j_new)):
        assert tk is t_caches[l][0]                   # written in place
        for got, want, old in ((tk, jk, k[l]), (tv, jv, v[l])):
            want = np.asarray(want._value)
            np.testing.assert_allclose(got.numpy()[:, rows], want[:, rows],
                                       **TOL)
            keep = np.ones(got.shape[1], bool)
            keep[rows] = False
            np.testing.assert_array_equal(got.numpy()[:, keep],
                                          old[:, keep])


def test_decode_step_module_matches_jax(models):
    jm, tm = models
    k, v = _bufs(seed=21)
    tokens = _ids(2, 1, seed=21)
    j_logits, j_k, j_v = JGPTDecodeStep(jm)(
        paddle.Tensor(tokens), paddle.Tensor(k), paddle.Tensor(v),
        paddle.Tensor(np.asarray(5, np.int32)))
    t_k, t_v = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    with torch.no_grad():
        logits, new_k, new_v = GPTDecodeStep(tm)(
            torch.from_numpy(tokens), t_k, t_v, torch.tensor(5))
    assert new_k is t_k and new_v is t_v
    assert tuple(logits.shape) == (2, 1, VOCAB)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits._value),
                               **TOL)
    np.testing.assert_allclose(new_k.numpy(), np.asarray(j_k._value), **TOL)
    np.testing.assert_allclose(new_v.numpy(), np.asarray(j_v._value), **TOL)


def test_generate_decodes_through_the_static_step(models, monkeypatch):
    """Every token after the first comes from one static-cache step a
    token, each a one-token chunk."""
    _, tm = models
    from paddle_tpu_torch.incubate.models import gpt as tgpt
    chunks = []
    step = tgpt.GPTAttention._decode_step

    def counting(self, q, k, v, cache, b, n):
        chunks.append(n)
        return step(self, q, k, v, cache, b, n)

    monkeypatch.setattr(tgpt.GPTAttention, "_decode_step", counting)
    tm.generate(_ids(2, 4, seed=8), max_new_tokens=5)
    assert chunks == [1] * (4 * CFG["num_hidden_layers"])
