"""Port parity: paddle_tpu_torch GPT model vs the JAX package's.

A tiny GPT (vocab 128, hidden 64, 2 layers) is built by the JAX package,
its weights carried into the port with `load_jax_state`, and the same
numpy token ids go through both. Two head counts: 4 heads (head_dim 16,
the plain attention path) and 1 head (head_dim 64, the flash route, which
on CPU tensors takes the kernel's plain twin).

Tolerance: 1e-5 absolute and relative, fp32 — the same products summed in
another order by XLA and by PyTorch.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           intermediate_size=128, max_position_embeddings=64,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _pair(heads):
    paddle.seed(0)
    jm = JGPTForCausalLM(JGPTConfig(num_attention_heads=heads, **CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(num_attention_heads=heads, **CFG),
                        device="cpu")
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    tm.eval()
    return jm, tm


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (2, n)) \
        .astype(np.int64)


@pytest.mark.parametrize("heads", [4, 1])
def test_full_forward_logits(heads):
    jm, tm = _pair(heads)
    ids = _ids(23)
    j = np.asarray(jm(paddle.to_tensor(ids))._value)
    with torch.no_grad():
        t = tm(torch.from_numpy(ids)).numpy()
    assert t.shape == (2, 23, 128)
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("heads", [4, 1])
def test_prefill_kv_and_logits(heads):
    """The dynamic-cache path with an empty past (the engine's prefill):
    logits and every layer's K/V."""
    jm, tm = _pair(heads)
    ids = _ids(17, seed=1)[:1]
    j_logits, j_caches = jm(paddle.to_tensor(ids), caches=jm.gen_caches(1))
    with torch.no_grad():
        t_logits, t_caches = tm(torch.from_numpy(ids),
                                caches=tm.gen_caches(1))
    np.testing.assert_allclose(t_logits.numpy(),
                               np.asarray(j_logits._value), **TOL)
    assert len(t_caches) == len(j_caches) == 2
    for (tk, tv), (jk, jv) in zip(t_caches, j_caches):
        assert tuple(tk.shape) == (1, 17, heads, 64 // heads)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk._value), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv._value), **TOL)


def test_parameter_names_match_the_jax_model():
    jm, tm = _pair(4)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]


def test_load_jax_state_raises_on_missing_extra_or_misshaped():
    jm, tm = _pair(4)
    arrays = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    missing = dict(arrays)
    del missing["gpt.h.1.mlp.fc_in.bias"]
    with pytest.raises(KeyError, match="gpt.h.1.mlp.fc_in.bias"):
        load_jax_state(tm, missing)
    with pytest.raises(KeyError, match="lm_head.weight"):
        load_jax_state(tm, {**arrays, "lm_head.weight": arrays["gpt.wte.weight"]})
    before = tm.gpt.wte.weight.detach().clone()
    bad = dict(arrays)
    # a Linear weight already in torch's [out, in] layout is mis-shaped
    bad["gpt.h.0.attn.qkv_proj.weight"] = arrays[
        "gpt.h.0.attn.qkv_proj.weight"].T
    bad["gpt.wte.weight"] = arrays["gpt.wte.weight"] + 1.0
    with pytest.raises(ValueError, match="qkv_proj"):
        load_jax_state(tm, bad)
    # nothing was copied before the check failed
    assert torch.equal(tm.gpt.wte.weight, before)


def test_model_without_device_raises_here():
    """Entry points default to cuda; this machine has no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForCausalLM(GPTConfig(**CFG))
