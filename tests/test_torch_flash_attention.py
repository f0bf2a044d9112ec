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

The bf16 kernel on the card rounds P to bf16 before O += P V on the tensor
cores; `chip_smoke.py` holds it to its twin under the forward's own bf16
criteria (`flash_fwd_bf16_tol`, `FLASH_FWD_BF16_FRO_RTOL`, kept beside the
kernel's wrapper). The tests below
emulate that rounding in plain torch and show the criteria pass with margin
against the JAX package, and fail when P is rounded coarser. The kernel
loads through TMA, whose alignment rule `_tma_compatible` states; it is
tested here on CPU tensors.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.nn.functional.attention import _plain_attention

from paddle_tpu_torch.incubate.models import GPTForCausalLM, gpt2_124m
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


def _round_bf16(p):
    return p.to(torch.bfloat16).float()


def _round_e4m3_like(p):
    """p with 3 mantissa bits kept (truncated), as an fp8 e4m3 value keeps;
    no exponent limit (only the mantissa's coarseness matters here)."""
    mant, exp = torch.frexp(p)                  # mant in [0.5, 1)
    return torch.ldexp(torch.floor(mant * 16) / 16, exp)


def _tensor_core_forward(q, k, v, causal, scale, round_p):
    """The bf16 kernel's arithmetic in plain torch: fp32 S from bf16 q, k;
    p = exp(s - rowmax) and l = sum p in fp32; O = round_p(p) @ v / l,
    rounded to bf16 once."""
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    s = (qt @ kt.transpose(-1, -2)) * scale
    if causal:
        n, m = s.shape[-2:]
        keep = torch.ones(n, m, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))   # masked: exactly 0
    out = (round_p(p) @ vt) / p.sum(-1, keepdim=True)
    return out.transpose(1, 2).to(torch.bfloat16)


def _bf16_criteria(out, ref, v):
    """The forward's two bf16 criteria as ratios to their limits (<= 1
    passes): max over elements of |out - ref| / (atol + rtol |ref|), and
    the relative Frobenius error over FLASH_FWD_BF16_FRO_RTOL."""
    atol, rtol = tfa.flash_fwd_bf16_tol(v)
    excess = ((out.float() - ref.float()).abs()
              / (atol + rtol * ref.float().abs())).max().item()
    return excess, tfa.rel_fro(out, ref) / tfa.FLASH_FWD_BF16_FRO_RTOL


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [8, 40, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_tolerance_bites_on_p_rounding(n, d, causal):
    """P rounded to bf16 (the kernel's design) passes both criteria with
    margin against the JAX package's fp32 attention on the same
    bf16-representable inputs. P rounded to 3 mantissa bits fails the
    Frobenius criterion everywhere, and the max-abs one where causal rows
    sit on few keys; non-causal rows over many keys average its error
    below the max-abs limit, which is why the Frobenius check is there."""
    b, h = 1, 2
    rng = np.random.default_rng(100 + n + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, d))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    if n % 128 == 0:
        ref, _ = jfa._flash_fwd(jq, jk, jv, causal, scale, block_q=128,
                                block_k=128, interpret=True)
    else:
        ref = _plain_attention(jq, jk, jv, None, causal, scale)
    ref = torch.from_numpy(np.array(ref, dtype=np.float32))
    good = _tensor_core_forward(q, k, v, causal, scale, _round_bf16)
    coarse = _tensor_core_forward(q, k, v, causal, scale, _round_e4m3_like)
    excess, fro = _bf16_criteria(good, ref, v)
    assert excess <= 0.5 and fro <= 0.75, (excess, fro)
    excess, fro = _bf16_criteria(coarse, ref, v)
    assert fro > 1 and (excess > 1 or not causal), (excess, fro)


def _online_forward(q, k, v, causal, scale, round_p, width):
    """The tensor-core kernel's online form in plain torch, key tile by key
    tile of `width` (64: the D = 64 kernel's and the 64-key variant's; 128:
    the D = 128 kernel's): fp32 S from bf16 q, k; P = exp(S - the running
    max) rounded by `round_p` before O += P V, l summed from the fp32 P,
    O and l rescaled in fp32 when the max moves; O / l rounded to bf16
    once, lse = max + log l (fp32)."""
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    b, h, n, d = qt.shape
    m = kt.shape[2]
    rows = torch.arange(n).reshape(n, 1)
    m_run = torch.full((b, h, n, 1), float("-inf"))
    l_run = torch.zeros((b, h, n, 1))
    o = torch.zeros((b, h, n, d))
    for k0 in range(0, m, width):
        s = (qt @ kt[:, :, k0:k0 + width].transpose(-1, -2)) * scale
        if causal:
            keys = torch.arange(k0, min(k0 + width, m)).reshape(1, -1)
            s = s.masked_fill(keys > rows, float("-inf"))
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        # a row with no unmasked key yet keeps p = 0 and alpha = 0
        base = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                           m_new)
        alpha = torch.exp(m_run - base)
        p = torch.exp(s - base)                   # masked: exactly 0
        l_run = l_run * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + round_p(p) @ vt[:, :, k0:k0 + width]
        m_run = m_new
    out = (o / l_run).transpose(1, 2).to(torch.bfloat16)
    return out, (m_run + torch.log(l_run)).reshape(b * h, n)


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("n", [200, 384])
@pytest.mark.parametrize("causal", [True, False])
def test_online_key_tiles_keep_the_bf16_margin_at_d128(width, n, causal):
    """At head_dim 128 the forward rounds P against the running max of
    each key tile, 64 or 128 keys wide, and rescales O in fp32 as the max
    moves: both widths pass the unchanged bf16 criteria with margin
    against the JAX package's fp32 attention, on lengths that cut a
    128-row tile (200) and that fill it (384); P rounded to 3 mantissa
    bits in the same online form still fails them."""
    b, h, d = 1, 2, 128
    rng = np.random.default_rng(300 + n + width)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, d))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    if n % 128 == 0:
        ref, ref_lse = jfa._flash_fwd(jq, jk, jv, causal, scale,
                                      block_q=128, block_k=128,
                                      interpret=True)
        ref_lse = torch.from_numpy(np.array(ref_lse, dtype=np.float32))
    else:
        ref = _plain_attention(jq, jk, jv, None, causal, scale)
        ref_lse = None
    ref = torch.from_numpy(np.array(ref, dtype=np.float32))
    good, lse = _online_forward(q, k, v, causal, scale, _round_bf16, width)
    coarse, _ = _online_forward(q, k, v, causal, scale, _round_e4m3_like,
                                width)
    excess, fro = _bf16_criteria(good, ref, v)
    assert excess <= 0.5 and fro <= 0.75, (excess, fro)
    if ref_lse is not None:
        np.testing.assert_allclose(lse.numpy(), ref_lse.numpy()[..., 0],
                                   **TOL)
    excess, fro = _bf16_criteria(coarse, ref, v)
    assert fro > 1 and (excess > 1 or not causal), (excess, fro)


def _bf16_buffer(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_tma_rule_accepts_the_models_fused_qkv_views():
    """GPT-2's attention hands the kernel q, k, v as views of the fused
    projection [B, N, 3, 12, 64]: row stride 3 * 768 elements (4608 B), k
    and v at 1536 and 3072 B. All three pass, at batch 1 and 2."""
    cfg = gpt2_124m()
    heads = cfg.num_attention_heads
    head_dim = cfg.hidden_size // heads
    for batch in (1, 2):
        qkv = _bf16_buffer(batch, 24, 3, heads, head_dim)
        for name, t in zip("qkv", qkv.unbind(2)):
            assert tfa._tma_compatible(t, name) is None
            strides = tfa._tma_strides(t)
            assert all(s > 0 and s % 8 == 0 for s in strides), strides
    model = GPTForCausalLM(gpt2_124m(num_hidden_layers=1), device="cpu")
    x = torch.zeros((2, 16, cfg.hidden_size))
    proj = model.gpt.h[0].attn.qkv_proj(x).to(torch.bfloat16)
    for name, t in zip("qkv", proj.view(2, 16, 3, heads, head_dim)
                       .unbind(2)):
        assert tfa._tma_compatible(t, name) is None


def test_tma_rule_rejects_misaligned_views_naming_the_tensor():
    width = 12 * 64
    # a view 2 bytes past a 16-byte boundary
    buf = _bf16_buffer(1, 16, 3 * width + 8)
    k = buf[..., 1:1 + width].view(1, 16, 12, 64)
    why = tfa._tma_compatible(k, "k")
    assert why is not None and why.startswith("k:") and "aligned" in why
    # rows 3 * width + 4 elements apart: not a multiple of 8 bf16
    buf = _bf16_buffer(1, 16, 3 * width + 4)
    v = buf[..., width:2 * width].view(1, 16, 12, 64)
    why = tfa._tma_compatible(v, "v")
    assert why is not None and why.startswith("v:") and "sequence" in why
    # a size-1 dimension's stride is never used, so it never disqualifies
    q = buf[:, :1, :width].view(1, 1, 12, 64)
    assert tfa._tma_compatible(q, "q") is None
    assert tfa._tma_strides(q)[1] % 8 == 0
