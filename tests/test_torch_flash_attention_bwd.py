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


def _round_bf16(x):
    return x.to(torch.bfloat16).float()


def _round_e4m3_like(x):
    """x with 3 mantissa bits kept (truncated), as an fp8 e4m3 value keeps;
    no exponent limit (only the mantissa's coarseness matters here)."""
    mant, exp = torch.frexp(x)                  # |mant| in [0.5, 1)
    return torch.ldexp(torch.trunc(mant * 16) / 16, exp)


def _tensor_core_backward(q, k, v, do, lse, delta, causal, scale, round_op):
    """The bf16 kernels' arithmetic in plain torch: fp32 S and dP from bf16
    q, k, v, dO; P = exp(scale S - lse) and dS = P (dP - Delta) in fp32; P
    and dS rounded by `round_op` before their products (dV = P^T dO, dQ =
    scale dS K, dK = scale dS^T Q), fp32 sums, one bf16 rounding of each
    output."""
    qt, kt, vt, gt = (t.transpose(1, 2).float() for t in (q, k, v, do))
    b, h, n, _ = qt.shape
    m = kt.shape[2]
    p = torch.exp((qt @ kt.transpose(-1, -2)) * scale
                  - lse.reshape(b, h, n, 1))
    if causal:
        p = p.masked_fill(~torch.ones(n, m, dtype=torch.bool).tril(), 0.0)
    ds = p * (gt @ vt.transpose(-1, -2) - delta.reshape(b, h, n, 1))
    grads = ((round_op(ds) @ kt) * scale,
             (round_op(ds).transpose(-1, -2) @ qt) * scale,
             round_op(p).transpose(-1, -2) @ gt)
    return [g.transpose(1, 2).to(torch.bfloat16) for g in grads]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [8, 40, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_backward_criteria_bite_on_operand_rounding(n, d, causal):
    """P and dS rounded to bf16 (the kernels' design) pass both bf16
    backward criteria (`flash_bwd_bf16_tol`, FLASH_BWD_BF16_FRO_RTOL) with
    margin against the JAX package's fp32 backward on the same
    bf16-representable inputs, for each of dQ, dK and dV; P and dS rounded
    to 3 mantissa bits fail both."""
    b, h = 1, 2
    rng = np.random.default_rng(200 + n + d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, n, h, d))
                                    .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    if n % 128 == 0:
        j_out, j_lse = jfa._flash_fwd(jq, jk, jv, causal, scale, block_q=128,
                                      block_k=128, interpret=True)
        ref = jfa._flash_bwd(jq, jk, jv, j_out, j_lse, jg, causal, scale,
                             block_q=128, block_k=128, interpret=True)
    else:
        _, vjp = jax.vjp(
            lambda qq, kk, vv: _plain_attention(qq, kk, vv, None, causal,
                                                scale), jq, jk, jv)
        ref = vjp(jg)
    ref = [torch.from_numpy(np.array(r, dtype=np.float32)) for r in ref]
    # the kernels' lse and Delta inputs, from the fp32 forward
    out, lse = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                             causal, scale)
    delta = tfa.flash_attention_delta(out, do.float())
    args = (q, k, v, do, lse, delta, causal, scale)
    tols = tfa.flash_bwd_bf16_tol(*args)
    good = _tensor_core_backward(*args, _round_bf16)
    coarse = _tensor_core_backward(*args, _round_e4m3_like)
    for name, g, c, r in zip(("dq", "dk", "dv"), good, coarse, ref):
        atol, rtol = tols[name]
        limit = atol + rtol * r.abs()
        excess = ((g.float() - r).abs() / limit).max().item()
        fro = tfa.rel_fro(g, r) / tfa.FLASH_BWD_BF16_FRO_RTOL
        assert excess <= 0.5 and fro <= 0.75, (name, excess, fro)
        excess = ((c.float() - r).abs() / limit).max().item()
        fro = tfa.rel_fro(c, r) / tfa.FLASH_BWD_BF16_FRO_RTOL
        assert excess > 1 and fro > 1, (name, excess, fro)


def _online_lse(q, k, causal, scale, width):
    """The forward kernel's lse in its online form: the running max and the
    fp32 sum rescaled key tile by key tile of `width`."""
    qt, kt = (t.transpose(1, 2).float() for t in (q, k))
    b, h, n, _ = qt.shape
    m = kt.shape[2]
    rows = torch.arange(n).reshape(n, 1)
    m_run = torch.full((b, h, n, 1), float("-inf"))
    l_run = torch.zeros((b, h, n, 1))
    for k0 in range(0, m, width):
        s = (qt @ kt[:, :, k0:k0 + width].transpose(-1, -2)) * scale
        if causal:
            keys = torch.arange(k0, min(k0 + width, m)).reshape(1, -1)
            s = s.masked_fill(keys > rows, float("-inf"))
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        l_run = (l_run * torch.exp(m_run - m_new)
                 + torch.exp(s - m_new).sum(-1, keepdim=True))
        m_run = m_new
    return (m_run + torch.log(l_run)).reshape(b * h, n)


def _tiled_dkv(q, k, v, do, lse, delta, causal, scale, round_op, width):
    """The dK/dV kernel's arithmetic in its tiled form: per key block of
    `width` (64: the D = 64 kernel's; 128: the D = 128 kernel's two
    warpgroups), streamed 64-query tiles; P = exp(scale S - lse) and dS =
    P (dP - Delta) in fp32, rounded by `round_op` before dV += P^T dO and
    dK += dS^T Q, which add in fp32 tile by tile; one bf16 rounding of
    each output."""
    qt, kt, vt, gt = (t.transpose(1, 2).float() for t in (q, k, v, do))
    b, h, n, d = qt.shape
    m = kt.shape[2]
    lse = lse.reshape(b, h, n, 1)
    delta = delta.reshape(b, h, n, 1)
    dk = torch.zeros((b, h, m, d))
    dv = torch.zeros((b, h, m, d))
    for k0 in range(0, m, width):
        keys = torch.arange(k0, min(k0 + width, m)).reshape(1, -1)
        kb, vb = kt[:, :, k0:k0 + width], vt[:, :, k0:k0 + width]
        for t0 in range(0, n, 64):
            rows = torch.arange(t0, min(t0 + 64, n)).reshape(-1, 1)
            qq, gg = qt[:, :, t0:t0 + 64], gt[:, :, t0:t0 + 64]
            p = torch.exp((qq @ kb.transpose(-1, -2)) * scale
                          - lse[:, :, t0:t0 + 64])
            if causal:
                p = p.masked_fill(keys > rows, 0.0)
            ds = p * (gg @ vb.transpose(-1, -2) - delta[:, :, t0:t0 + 64])
            dv[:, :, k0:k0 + width] += round_op(p).transpose(-1, -2) @ gg
            dk[:, :, k0:k0 + width] += (round_op(ds).transpose(-1, -2)
                                        @ qq)
    return [(g * f).transpose(1, 2).to(torch.bfloat16)
            for g, f in ((dk, scale), (dv, 1.0))]


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("n", [200, 384])
@pytest.mark.parametrize("causal", [True, False])
def test_tiled_dkv_keeps_the_bf16_margin_at_d128(width, n, causal):
    """At head_dim 128, dK and dV from key blocks of 64 or 128 keys (the
    D = 128 kernel's two warpgroups share each 64-query tile), fed the
    forward's online lse (key tiles of the same width) and a Delta from
    its bf16 output: both widths pass the unchanged bf16 backward criteria
    with margin against the JAX package's fp32 backward, on lengths that
    cut a 128-key block (200) and that fill it (384); P and dS rounded to
    3 mantissa bits in the same form still fail them."""
    b, h, d = 1, 2, 128
    rng = np.random.default_rng(400 + n + width)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, n, h, d))
                                    .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    if n % 128 == 0:
        j_out, j_lse = jfa._flash_fwd(jq, jk, jv, causal, scale, block_q=128,
                                      block_k=128, interpret=True)
        ref = jfa._flash_bwd(jq, jk, jv, j_out, j_lse, jg, causal, scale,
                             block_q=128, block_k=128, interpret=True)
    else:
        _, vjp = jax.vjp(
            lambda qq, kk, vv: _plain_attention(qq, kk, vv, None, causal,
                                                scale), jq, jk, jv)
        ref = vjp(jg)
    ref = [torch.from_numpy(np.array(r, dtype=np.float32)) for r in ref[1:]]
    lse = _online_lse(q, k, causal, scale, width)
    out, _ = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                           causal, scale)
    delta = tfa.flash_attention_delta(out.to(torch.bfloat16), do)
    args = (q, k, v, do, lse, delta, causal, scale)
    tols = tfa.flash_bwd_bf16_tol(*args)
    good = _tiled_dkv(*args, _round_bf16, width)
    coarse = _tiled_dkv(*args, _round_e4m3_like, width)
    for name, g, c, r in zip(("dk", "dv"), good, coarse, ref):
        atol, rtol = tols[name]
        limit = atol + rtol * r.abs()
        excess = ((g.float() - r).abs() / limit).max().item()
        fro = tfa.rel_fro(g, r) / tfa.FLASH_BWD_BF16_FRO_RTOL
        assert excess <= 0.5 and fro <= 0.75, (name, excess, fro)
        excess = ((c.float() - r).abs() / limit).max().item()
        fro = tfa.rel_fro(c, r) / tfa.FLASH_BWD_BF16_FRO_RTOL
        assert excess > 1 and fro > 1, (name, excess, fro)


def _tiled_dq(q, k, v, do, lse, delta, causal, scale, round_op, width):
    """The dQ kernel's arithmetic in its tiled form: per query block of
    `width` rows (64: the D = 64 kernel's; 128: the D = 128 kernel's two
    warpgroups sharing each K/V tile), streamed 64-key tiles up to the
    block's diagonal; P = exp(scale S - lse) and dS = P (dP - Delta) in
    fp32, dS rounded by `round_op` before dQ += dS K, which adds in fp32
    tile by tile; one bf16 rounding of dQ, times scale."""
    qt, kt, vt, gt = (t.transpose(1, 2).float() for t in (q, k, v, do))
    b, h, n, d = qt.shape
    m = kt.shape[2]
    lse = lse.reshape(b, h, n, 1)
    delta = delta.reshape(b, h, n, 1)
    dq = torch.zeros((b, h, n, d))
    for q0 in range(0, n, width):
        rows = torch.arange(q0, min(q0 + width, n)).reshape(-1, 1)
        qq, gg = qt[:, :, q0:q0 + width], gt[:, :, q0:q0 + width]
        kv_end = min(m, q0 + width) if causal else m
        for k0 in range(0, kv_end, 64):
            keys = torch.arange(k0, min(k0 + 64, m)).reshape(1, -1)
            kb, vb = kt[:, :, k0:k0 + 64], vt[:, :, k0:k0 + 64]
            p = torch.exp((qq @ kb.transpose(-1, -2)) * scale
                          - lse[:, :, q0:q0 + width])
            if causal:
                p = p.masked_fill(keys > rows, 0.0)
            ds = p * (gg @ vb.transpose(-1, -2) - delta[:, :, q0:q0 + width])
            dq[:, :, q0:q0 + width] += round_op(ds) @ kb
    return (dq * scale).transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("n", [200, 384])
@pytest.mark.parametrize("causal", [True, False])
def test_tiled_dq_keeps_the_bf16_margin_at_d128(width, n, causal):
    """At head_dim 128, dQ from query blocks of 64 or 128 rows (the D = 128
    kernel's two warpgroups share each streamed 64-key K/V tile), fed the
    forward's online lse (key tiles of the same width) and a Delta from
    its bf16 output: both widths pass the unchanged bf16 backward criteria
    with margin (at most 3/4 of each) against the JAX package's fp32
    backward, on lengths that cut a 128-row block (200) and that fill it
    (384); dS rounded to 3 mantissa bits in the same form still fails
    them. A row adds its key tiles in one order whatever the block's
    width, so the widths differ only in the lse; the largest element-wise
    share, 0.55 at n = 200 causal (query 1, two keys), comes from the
    Delta of the bf16 output, which no tiling changes."""
    b, h, d = 1, 2, 128
    rng = np.random.default_rng(500 + n + width)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, n, h, d))
                                    .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    if n % 128 == 0:
        j_out, j_lse = jfa._flash_fwd(jq, jk, jv, causal, scale, block_q=128,
                                      block_k=128, interpret=True)
        ref = jfa._flash_bwd(jq, jk, jv, j_out, j_lse, jg, causal, scale,
                             block_q=128, block_k=128, interpret=True)
    else:
        _, vjp = jax.vjp(
            lambda qq, kk, vv: _plain_attention(qq, kk, vv, None, causal,
                                                scale), jq, jk, jv)
        ref = vjp(jg)
    ref = torch.from_numpy(np.array(ref[0], dtype=np.float32))
    lse = _online_lse(q, k, causal, scale, width)
    out, _ = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                           causal, scale)
    delta = tfa.flash_attention_delta(out.to(torch.bfloat16), do)
    args = (q, k, v, do, lse, delta, causal, scale)
    atol, rtol = tfa.flash_bwd_bf16_tol(*args)["dq"]
    limit = atol + rtol * ref.abs()
    good = _tiled_dq(*args, _round_bf16, width)
    excess = ((good.float() - ref).abs() / limit).max().item()
    fro = tfa.rel_fro(good, ref) / tfa.FLASH_BWD_BF16_FRO_RTOL
    assert excess <= 0.75 and fro <= 0.75, (excess, fro)
    coarse = _tiled_dq(*args, _round_e4m3_like, width)
    excess = ((coarse.float() - ref).abs() / limit).max().item()
    fro = tfa.rel_fro(coarse, ref) / tfa.FLASH_BWD_BF16_FRO_RTOL
    assert excess > 1 and fro > 1, (excess, fro)


def test_bwd_tma_rule_takes_strided_do_and_fused_views_names_do():
    """The bf16 backward kernels read q, k, v and dO through TMA: the fused
    qkv views of GPT-2's projection ([B, N, 3, 12, 64]) and a gradient laid
    out [B, H, N, D] and viewed as [B, N, H, D] (the strided dO the card
    check uses) pass; a dO 2 bytes off a 16-byte boundary is refused,
    naming it."""
    b, n, heads, head_dim = 2, 24, 12, 64
    qkv = torch.zeros((b, n, 3, heads, head_dim), dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.zeros((b, heads, n, head_dim),
                     dtype=torch.bfloat16).transpose(1, 2)
    tfa._require_tma("flash_attention_bwd_dq", q=q, k=k, v=v, do=do)
    for t in (q, k, v, do):
        assert all(s > 0 and s % 8 == 0 for s in tfa._tma_strides(t))
    width = heads * head_dim
    buf = torch.zeros((b, n, width + 8), dtype=torch.bfloat16)
    bad = buf[..., 1:1 + width].view(b, n, heads, head_dim)
    with pytest.raises(ValueError, match=r"cannot read do: base address"):
        tfa._require_tma("flash_attention_bwd_dkv", q=q, k=k, v=v, do=bad)


def test_backward_copies_only_a_do_the_kernels_cannot_read(monkeypatch):
    """`FlashAttention.backward` hands the kernels a bf16 dO that is 2 bytes
    off a 16-byte boundary (contiguous all the same) as a fresh copy that
    TMA can read, with the same gradients; a strided but aligned dO (laid
    out [B, H, N, D]) goes through in place."""
    seen = []
    real = tfa.flash_attention_bwd

    def spy(q, k, v, out, lse, do, causal, scale):
        seen.append(do)
        return real(q, k, v, out, lse, do, causal, scale)

    monkeypatch.setattr(tfa, "flash_attention_bwd", spy)
    b, n, h, d = 1, 16, 2, 64
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _arrays((b, n, h, d), seed=7))
    buf = torch.zeros(b * n * h * d + 8, dtype=torch.bfloat16)
    bad = buf[1:1 + b * n * h * d].view(b, n, h, d)
    bad.copy_(g)
    strided = g.transpose(1, 2).contiguous().transpose(1, 2)
    grads = []
    for do in (bad, strided, g):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        tfa.flash_attention_bnhd(*leaves, causal=True).backward(do)
        grads.append([t.grad for t in leaves])
    assert bad.is_contiguous() and tfa._tma_compatible(bad, "do")
    assert seen[0].data_ptr() != bad.data_ptr()
    assert tfa._tma_compatible(seen[0], "do") is None
    assert seen[1].data_ptr() == strided.data_ptr()
    for got, want in zip(grads[:2], [grads[2]] * 2):
        for a, e in zip(got, want):
            torch.testing.assert_close(a, e, rtol=0, atol=0)
