"""Port parity: paddle_tpu_torch flash attention backward vs the JAX package.

The JAX side runs the Pallas backward through the interpreter
(`_flash_bwd(..., interpret=True)`, as tests/test_fused_kernels.py does) or
differentiates its plain `_plain_attention` with `jax.vjp`; the port runs on
CPU tensors, where `flash_attention_bwd` takes its plain twin
`flash_attention_bwd_reference` and `FlashAttention` joins it to the
forward. Inputs are made once with numpy (float32, explicitly: the JAX
package enables x64) and fed to both.

Tolerance: 1e-4 absolute and relative on dQ, dK and dV, fp32 — the bound the
JAX package's own backward test uses; each gradient sums up to 256 products
of (probability x value) terms, and the two sides add them in different
orders (blocked kernels vs one dense product).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.nn.functional.attention import _plain_attention

from paddle_tpu_torch.framework import get_flags, set_flags
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

TOL = dict(rtol=1e-4, atol=1e-4)


def _arrays(shape, seed, count=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(count)]


def _leaf(a):
    return torch.from_numpy(a.copy()).requires_grad_(True)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_pallas_interpret(causal):
    b, n, h, d = 2, 256, 2, 64
    q, k, v, g = _arrays((b, n, h, d), seed=0)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    j_out, j_lse = jfa._flash_fwd(jq, jk, jv, causal, scale, block_q=128,
                                  block_k=128, interpret=True)
    j_grads = jfa._flash_bwd(jq, jk, jv, j_out, j_lse, jg, causal, scale,
                             block_q=128, block_k=128, interpret=True)
    # the same forward results into both backwards
    t_grads = tfa.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v, np.array(j_out))),
        torch.from_numpy(np.array(j_lse)[..., 0]), torch.from_numpy(g),
        causal, scale)
    for name, t, j in zip(("dq", "dk", "dv"), t_grads, j_grads):
        assert t.shape == (b, n, h, d), name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_gradients_match_plain_attention_vjp(causal):
    """n = 40, a length the TPU kernels never take: the port's autograd
    flash route against `jax.vjp` of the JAX package's plain attention."""
    b, n, h, d = 1, 40, 3, 64
    q, k, v, g = _arrays((b, n, h, d), seed=n)
    scale = 1.0 / math.sqrt(d)
    ref_out, vjp = jax.vjp(
        lambda qq, kk, vv: _plain_attention(qq, kk, vv, None, causal, scale),
        *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    tq, tk, tv = map(_leaf, (q, k, v))
    out = tfa.flash_attention_bnhd(tq, tk, tv, causal)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **TOL)
    for name, t, j in zip(("dq", "dk", "dv"), (tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   err_msg=name, **TOL)


def test_sdpa_with_grad_goes_through_the_flash_function():
    """The repaired route: attention on tensors that require grad returns
    an output whose grad_fn is FlashAttention's backward node, and its
    gradients are the plain path's."""
    q, k, v, g = _arrays((2, 24, 1, 64), seed=3)
    tq, tk, tv = map(_leaf, (q, k, v))
    out = scaled_dot_product_attention(tq, tk, tv, is_causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(g))
    pq, pk, pv = map(_leaf, (q, k, v))
    set_flags({"FLAGS_use_flash_attention": False})
    try:
        plain = scaled_dot_product_attention(pq, pk, pv, is_causal=True)
    finally:
        set_flags({"FLAGS_use_flash_attention": True})
    assert type(plain.grad_fn).__name__ != "FlashAttentionBackward"
    plain.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), plain.detach().numpy(),
                               **TOL)
    for t, p in zip((tq, tk, tv), (pq, pk, pv)):
        np.testing.assert_allclose(t.grad.numpy(), p.grad.numpy(), **TOL)


def test_strided_views_and_an_expanded_gradient():
    """q/k/v as strided views of one fused qkv leaf (the model's layout),
    differentiated through a sum (whose gradient arrives expanded, stride
    0): the gradient of the fused tensor equals the contiguous one's."""
    b, n, h, d = 1, 24, 2, 128
    rng = np.random.default_rng(4)
    base = rng.standard_normal((b, n, 3, h, d)).astype(np.float32)
    fused = _leaf(base)
    tfa.flash_attention_bnhd(*fused.unbind(2), causal=True).sum().backward()
    parts = [_leaf(np.ascontiguousarray(base[:, :, i])) for i in range(3)]
    tfa.flash_attention_bnhd(*parts, causal=True).sum().backward()
    want = torch.stack([p.grad for p in parts], dim=2)
    np.testing.assert_array_equal(fused.grad.numpy(), want.numpy())


def test_no_grad_keeps_one_forward_and_no_graph():
    q, k, v = map(_leaf, _arrays((1, 8, 2, 64), seed=5, count=3))
    with torch.no_grad():
        out = scaled_dot_product_attention(q, k, v, is_causal=True)
    assert out.grad_fn is None and not out.requires_grad


def test_bwd_wrapper_rejects_what_the_kernels_cannot_take():
    q, k, v, g = map(torch.from_numpy, _arrays((1, 8, 2, 64), seed=6))
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    with pytest.raises(ValueError, match="n == m"):
        tfa.flash_attention_bwd(q, k[:, :4], v[:, :4], out, lse, g, True)
    assert get_flags("FLAGS_use_flash_attention") == {
        "FLAGS_use_flash_attention": True}
