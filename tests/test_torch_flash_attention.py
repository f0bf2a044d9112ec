"""Port parity: paddle_tpu_torch flash attention forward vs the JAX package.

The JAX side runs the Pallas kernel through the interpreter
(`_flash_fwd(..., interpret=True)`, as tests/test_fused_kernels.py does) or
its plain `_plain_attention`; the port runs on CPU tensors, where the
wrapper takes its plain twin `flash_attention_reference`. Inputs are made
once with numpy (float32, explicitly: the JAX package enables x64) and fed
to both.

Tolerance: 2e-5 absolute and relative on O and lse, fp32 — the two sides
sum the same products in different orders (blockwise online softmax vs one
dense softmax), which moves the last few bits only.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.nn.functional.attention import _plain_attention

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_pallas_interpret(causal):
    b, n, h, d = 2, 256, 2, 64
    q, k, v = _qkv((b, n, h, d), seed=0)
    scale = 1.0 / math.sqrt(d)
    j_out, j_lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal, scale,
                                  block_q=128, block_k=128, interpret=True)
    t_out, t_lse = tfa.flash_attention_fwd(torch.from_numpy(q),
                                           torch.from_numpy(k),
                                           torch.from_numpy(v), causal, scale)
    assert t_out.shape == (b, n, h, d) and t_lse.shape == (b * h, n)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[..., 0],
                               **TOL)


@pytest.mark.parametrize("n", [8, 40])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_lengths_match_plain_attention(n, causal):
    """Lengths the TPU kernel never takes (not multiples of 128): the
    port's flash route against the JAX package's plain attention."""
    b, h, d = 1, 3, 64
    q, k, v = _qkv((b, n, h, d), seed=n)
    scale = 1.0 / math.sqrt(d)
    ref = np.asarray(_plain_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), None, causal, scale))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, _ = tfa.flash_attention_fwd(tq, tk, tv, causal, scale)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    sdpa = scaled_dot_product_attention(tq, tk, tv, is_causal=causal)
    np.testing.assert_allclose(sdpa.numpy(), ref, **TOL)


def test_strided_views_of_a_fused_projection():
    """The model hands the kernel q/k/v as strided views of one qkv
    tensor; the result must equal the contiguous computation."""
    b, n, h, d = 1, 24, 2, 128
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(
        rng.standard_normal((b, n, 3, h, d)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    ref, ref_lse = tfa.flash_attention_reference(
        q.contiguous(), k.contiguous(), v.contiguous(), True)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    np.testing.assert_array_equal(lse.numpy(), ref_lse.numpy())


def test_sdpa_cached_keys_use_bottom_right_alignment():
    """n < m causal (cached keys) is not the kernel's top-left mask: SDPA
    takes the plain path and matches the JAX plain attention."""
    q, _, _ = _qkv((1, 4, 2, 64), seed=5)
    _, k, v = _qkv((1, 10, 2, 64), seed=6)
    ref = np.asarray(_plain_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), None, True,
                                      1.0 / 8.0))
    out = scaled_dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                       is_causal=True)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    q, k, v = map(torch.from_numpy, _qkv((1, 8, 2, 64), seed=7))
    with pytest.raises(ValueError, match="n == m"):
        tfa.flash_attention_fwd(q, k[:, :4], v[:, :4], True)
    with pytest.raises(ValueError, match="mismatched"):
        tfa.flash_attention_fwd(q, k[..., :32], v, False)
