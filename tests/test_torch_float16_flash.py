"""Port parity: float16 flash attention, forward and backward, vs the JAX
package.

The JAX side runs its Pallas kernels through the interpreter
(`_flash_fwd` / `_flash_bwd(..., interpret=True)`) or its plain attention
(`jax.vjp` of it for gradients) on the same float16 values; the port runs
on CPU tensors, where the wrappers take their plain twins. Inputs are made
once with numpy and fed to both.

  * the f16 twins against the JAX kernels on f16 inputs (whose Pallas
    bodies upcast to fp32 and round the outputs to f16 once): outputs
    within one f16 step (rtol 2e-3; atol 1e-4 for values near 0), lse and
    the fp32 paths within 1e-4;
  * the f16 kernels' own arithmetic in plain torch (P and dS rounded to f16
    before the tensor cores, subnormals included; dS under the kernels'
    per-row power-of-two factor and its guard, `f16_big` and `fit_f16` in
    csrc/flash_attention_bwd.cu, `_fit_rows` here)
    passes the f16 criteria (`flash_fwd_f16_tol`, `flash_bwd_f16_tol` and
    the Frobenius limits) with margin against the JAX package's fp32
    attention, and fails them when P and dS keep 3 mantissa bits;
  * a dO large enough that dS passes f16's largest value (65504) where
    dQ, dK and dV still fit (a GradScaler's scaled loss): dS rounded to
    f16 as it is overflows, the kernels' factor keeps every gradient
    finite and within the criteria;
  * the guard's rule at its edges (2^15 in f16 rounding and in fp32,
    65504, inf; the fp32 test against the packed f16 bits), the plain rounding where no tile triggers it, and the
    earlier design's outputs (`_fit_rows_fp32`) wherever rows drop.
The card holds the kernels themselves to the same criteria
(`chip_smoke.py`).
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

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

F16_TOL = dict(rtol=2e-3, atol=1e-4)
LSE_TOL = dict(rtol=1e-4, atol=1e-4)


def _f16(shape, seed, count=3, gain=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(shape) * gain)
                             .astype(np.float32)).to(torch.float16)
            for _ in range(count)]


def _j(t):
    """An f16 tensor as a JAX f16 array (exact through fp32)."""
    return jnp.asarray(t.float().numpy()).astype(jnp.float16)


def _round_f16(x):
    return x.to(torch.float16).float()


def _round_e4m3_like(x):
    """x with 3 mantissa bits kept (truncated), no exponent limit."""
    mant, exp = torch.frexp(x)
    return torch.ldexp(torch.trunc(mant * 16) / 16, exp)


@pytest.mark.parametrize("causal", [True, False])
def test_f16_forward_matches_pallas_interpret(causal):
    b, n, h, d = 1, 256, 2, 64
    q, k, v = _f16((b, n, h, d), seed=1)
    scale = 1.0 / math.sqrt(d)
    j_out, j_lse = jfa._flash_fwd(_j(q), _j(k), _j(v), causal, scale,
                                  block_q=128, block_k=128, interpret=True)
    assert j_out.dtype == jnp.float16
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, scale)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(j_out, dtype=np.float32),
                               **F16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0],
                               **LSE_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_f16_backward_matches_pallas_interpret(causal):
    b, n, h, d = 1, 256, 2, 64
    q, k, v, g = _f16((b, n, h, d), seed=2, count=4)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = map(_j, (q, k, v, g))
    j_out, j_lse = jfa._flash_fwd(jq, jk, jv, causal, scale, block_q=128,
                                  block_k=128, interpret=True)
    j_grads = jfa._flash_bwd(jq, jk, jv, j_out, j_lse, jg, causal, scale,
                             block_q=128, block_k=128, interpret=True)
    t_grads = tfa.flash_attention_bwd(
        q, k, v, torch.from_numpy(np.array(j_out, dtype=np.float32))
        .to(torch.float16), torch.from_numpy(np.array(j_lse)[..., 0]), g,
        causal, scale)
    for name, t, j in zip(("dq", "dk", "dv"), t_grads, j_grads):
        assert t.dtype == torch.float16, name
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, dtype=np.float32),
                                   err_msg=name, rtol=2e-3, atol=2e-3)


def test_sdpa_routes_float16_through_the_flash_function():
    """A float16 call of the port's SDPA takes the autograd FlashAttention
    (the kernels on the card, their twins here) and matches the JAX
    package's plain attention on the same values, with gradients."""
    b, n, h, d = 1, 40, 2, 64
    q, k, v, g = _f16((b, n, h, d), seed=3, count=4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = scaled_dot_product_attention(*leaves, is_causal=True)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(g)
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    ref, vjp = jax.vjp(lambda a, bb, c: _plain_attention(
        a, bb, c, None, True, 1.0 / math.sqrt(d)), jq, jk, jv)
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref),
                               **F16_TOL)
    for leaf, want in zip(leaves, vjp(jnp.asarray(g.float().numpy()))):
        np.testing.assert_allclose(leaf.grad.float().numpy(),
                                   np.asarray(want), rtol=5e-3, atol=5e-3)


def _tensor_core_forward(q, k, v, causal, scale, round_p):
    """The f16 kernel's arithmetic in plain torch: fp32 S from f16 q, k;
    p = exp(s - rowmax) and l = sum p in fp32 (the P the reference sums);
    O = round_p(p) @ v / l, rounded to f16 once."""
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    s = (qt @ kt.transpose(-1, -2)) * scale
    if causal:
        n, m = s.shape[-2:]
        s = s.masked_fill(~torch.ones(n, m, dtype=torch.bool).tril(),
                          float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = (round_p(p) @ vt) / p.sum(-1, keepdim=True)
    return out.transpose(1, 2).to(torch.float16)


def _jax_forward(q, k, v, causal, scale):
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    if q.shape[1] % 128 == 0:
        ref, _ = jfa._flash_fwd(jq, jk, jv, causal, scale, block_q=128,
                                block_k=128, interpret=True)
    else:
        ref = _plain_attention(jq, jk, jv, None, causal, scale)
    return torch.from_numpy(np.array(ref, dtype=np.float32))


def _fwd_criteria(out, ref, v):
    atol, rtol = tfa.flash_fwd_f16_tol(v)
    excess = ((out.float() - ref).abs() / (atol + rtol * ref.abs())).max()
    return float(excess), tfa.rel_fro(out, ref) / tfa.FLASH_FWD_F16_FRO_RTOL


@pytest.mark.parametrize("gain", [1.0, 3.0])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [8, 40, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_f16_forward_criteria_bite_on_p_rounding(n, d, causal, gain):
    """P rounded to f16 (the kernel's design; with q 3 times larger many
    probabilities fall below 2^-14 into f16's subnormals) passes both f16
    criteria with margin against the JAX package's fp32 attention on the
    same f16 values; P with 3 mantissa bits fails the Frobenius one."""
    q, k, v = _f16((1, n, 2, d), seed=300 + n + d)
    q = (q.float() * gain).to(torch.float16)
    scale = 1.0 / math.sqrt(d)
    ref = _jax_forward(q, k, v, causal, scale)
    good = _tensor_core_forward(q, k, v, causal, scale, _round_f16)
    coarse = _tensor_core_forward(q, k, v, causal, scale, _round_e4m3_like)
    excess, fro = _fwd_criteria(good, ref, v)
    assert excess <= 0.5 and fro <= 0.75, (excess, fro)
    excess, fro = _fwd_criteria(coarse, ref, v)
    assert fro > 1, (excess, fro)


# the f16 kernels' dS guard (csrc/flash_attention_bwd.cu): kDsMax, the
# least magnitude that rounds to 2^15 or more in f16 (kF16Round), the rows
# of a warp, and the f16 bits of 2^15
KDS_MAX = 2.0 ** 15
F16_ROUND = 32760.0
WARP_ROWS = 16
F16_2_15 = 0x7800


def _vote_rows(y):
    """The kernels' test, by row of `y` [..., rows, cols]: whether a value
    of the row has magnitude kF16Round or more, that is, would round to
    2^15 or more in f16 (NaN aside: fmaxf passes it over)."""
    return (y.abs() >= F16_ROUND).any(-1)


def _f16_big(y):
    """The same test on the values packed to f16, as a vote on the packed
    words would read their bits: |h| + 0x0800 sets bit 15."""
    bits = y.to(torch.float16).view(torch.int16).to(torch.int32) & 0x7FFF
    return ((bits + (0x8000 - F16_2_15)) & 0x8000).ne(0).any(-1)


def _warp_any(flags, warp=WARP_ROWS):
    """`flags` [..., rows] -> whether any row of each row's warp holds
    it: rows in groups of 16 from the first, as the kernels' four warps
    take a 64-row tile (one vote a warp)."""
    rows = flags.shape[-1]
    pad = flags.new_zeros(*flags.shape[:-1], -rows % warp)
    grouped = torch.cat([flags, pad], -1).unflatten(-1, (-1, warp))
    return grouped.any(-1, keepdim=True).expand_as(grouped) \
        .flatten(-2)[..., :rows]


def _fit_rows(ds, round_op, tile=64, factors=None):
    """dS as the f16 kernels hand it to the tensor cores, in fp32: rows
    streamed in tiles of 64 along the last dimension, in warps of 16
    rows. Each row keeps a power-of-two factor, 1 at first; a tile's
    values of a row are formed times it (`y`). A warp with every row at
    factor 1 tests y (`_vote_rows`) and takes one vote; where no row
    finds a value it goes on, else, and on every tile once a row
    of the warp is below factor 1 (`scaled`), each row whose fp32 |y|
    passes 2^15 (kDsMax) drops its factor by the largest power of two that
    brings it under (`fit_f16`; frexp of inf gives 1: an inf dS stays
    inf). Each tile is rounded by `round_op` at the factor of its turn,
    then divided back (exact: powers of two). A list `factors` gets the
    rows' factors after each tile."""
    out = torch.empty_like(ds)
    mul = torch.ones(ds.shape[:-1])
    scaled = torch.zeros(ds.shape[:-1], dtype=torch.bool)
    for t0 in range(0, ds.shape[-1], tile):
        y = ds[..., t0:t0 + tile] * mul[..., None]
        fit = scaled | _warp_any(_vote_rows(y))
        big = y.abs().amax(-1)
        _, e = torch.frexp(big / KDS_MAX)
        f = torch.where(fit & (big > KDS_MAX),
                        torch.ldexp(torch.ones_like(mul), -e),
                        torch.ones_like(mul))
        mul = mul * f
        scaled = _warp_any(mul != 1)
        if factors is not None:
            factors.append(mul)
        out[..., t0:t0 + tile] = round_op(y * f[..., None]) / mul[..., None]
    return out


def _fit_rows_fp32(ds, round_op, tile=64):
    """The earlier design's dS (its `fit_f16` on every tile): each row's
    factor drops where a tile's fp32 |dS| times it passes 2^15, with no
    packed test before."""
    out = torch.empty_like(ds)
    mul = torch.ones(ds.shape[:-1])
    for t0 in range(0, ds.shape[-1], tile):
        blk = ds[..., t0:t0 + tile]
        big = blk.abs().amax(-1) * mul
        _, e = torch.frexp(big / KDS_MAX)
        mul = torch.where(big > KDS_MAX,
                          mul * torch.ldexp(torch.ones_like(mul), -e), mul)
        out[..., t0:t0 + tile] = round_op(blk * mul[..., None]) \
            / mul[..., None]
    return out


def _tensor_core_backward(q, k, v, do, lse, delta, causal, scale, round_op,
                          fit=True):
    """The f16 kernels' arithmetic in plain torch: fp32 S and dP; P and
    dS in fp32, rounded by `round_op` before their products (dS under the
    kernels' row factors, rows of queries for dQ and of keys for dK, when
    `fit`); fp32 sums; one f16 rounding of each output."""
    qt, kt, vt, gt = (t.transpose(1, 2).float() for t in (q, k, v, do))
    b, h, n, _ = qt.shape
    m = kt.shape[2]
    p = torch.exp((qt @ kt.transpose(-1, -2)) * scale
                  - lse.reshape(b, h, n, 1))
    if causal:
        p = p.masked_fill(~torch.ones(n, m, dtype=torch.bool).tril(), 0.0)
    ds = p * (gt @ vt.transpose(-1, -2) - delta.reshape(b, h, n, 1))
    if fit:
        ds_q = _fit_rows(ds, round_op)
        ds_k = _fit_rows(ds.transpose(-1, -2), round_op)
    else:
        ds_q, ds_k = round_op(ds), round_op(ds.transpose(-1, -2))
    grads = ((ds_q @ kt) * scale, (ds_k @ qt) * scale,
             round_op(p).transpose(-1, -2) @ gt)
    return [g.transpose(1, 2).to(torch.float16) for g in grads]


def _jax_backward(q, k, v, do, causal, scale):
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    if q.shape[1] % 128 == 0:
        j_out, j_lse = jfa._flash_fwd(jq, jk, jv, causal, scale, block_q=128,
                                      block_k=128, interpret=True)
        ref = jfa._flash_bwd(jq, jk, jv, j_out, j_lse, jg, causal, scale,
                             block_q=128, block_k=128, interpret=True)
    else:
        _, vjp = jax.vjp(lambda a, bb, c: _plain_attention(
            a, bb, c, None, causal, scale), jq, jk, jv)
        ref = vjp(jg)
    return [torch.from_numpy(np.array(r, dtype=np.float32)) for r in ref]


def _bwd_case(q, k, v, do, causal, scale):
    """The kernels' lse and Delta inputs from the fp32 forward, and the
    f16 criteria of the case."""
    out, lse = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                             causal, scale)
    delta = tfa.flash_attention_delta(out, do.float())
    args = (q, k, v, do, lse, delta, causal, scale)
    return args, tfa.flash_bwd_f16_tol(*args)


def _bwd_criteria(name, got, ref, tols):
    atol, rtol = tols[name]
    excess = ((got.float() - ref).abs() / (atol + rtol * ref.abs())).max()
    return float(excess), tfa.rel_fro(got, ref) / tfa.FLASH_BWD_F16_FRO_RTOL


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [8, 40, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_f16_backward_criteria_bite_on_operand_rounding(n, d, causal):
    """P and dS rounded to f16 (the kernels' design) pass both f16
    backward criteria with margin against the JAX package's fp32 backward
    on the same f16 values, for each of dQ, dK and dV; P and dS with 3
    mantissa bits fail both."""
    q, k, v, do = _f16((1, n, 2, d), seed=400 + n + d, count=4)
    scale = 1.0 / math.sqrt(d)
    ref = _jax_backward(q, k, v, do, causal, scale)
    args, tols = _bwd_case(q, k, v, do, causal, scale)
    good = _tensor_core_backward(*args, _round_f16)
    coarse = _tensor_core_backward(*args, _round_e4m3_like)
    for name, g, c, r in zip(("dq", "dk", "dv"), good, coarse, ref):
        excess, fro = _bwd_criteria(name, g, r, tols)
        assert excess <= 0.5 and fro <= 0.75, (name, excess, fro)
        excess, fro = _bwd_criteria(name, c, r, tols)
        assert excess > 1 and fro > 1, (name, excess, fro)


@pytest.mark.parametrize("causal", [True, False])
def test_f16_backward_large_do_needs_the_ds_factor(causal):
    """dO of order 10^4 (a loss scaled by 2^15 reaches it) drives |dP -
    Delta| past 10^4 and |dS| past 65504 while the fp32 gradients still
    fit in f16: dS rounded to f16 as it is overflows to inf, the kernels'
    row factors keep dQ, dK and dV finite and within the f16 criteria."""
    n, d = 128, 64
    q, k, v = _f16((1, n, 2, d), seed=21)
    q = (q.float() * 2).to(torch.float16)      # peaked rows: P near 1
    (g,) = _f16((1, n, 2, d), seed=22, count=1,
                gain=11000.0 if causal else 13000.0)
    scale = 1.0 / math.sqrt(d)
    ref = _jax_backward(q, k, v, g, causal, scale)
    args, tols = _bwd_case(q, k, v, g, causal, scale)
    _, _, _, _, ds = tfa._bwd_probs(*args)
    assert float(ds.abs().max()) > 65504.0
    assert all(float(r.abs().max()) < 65504.0 for r in ref)
    plain = _tensor_core_backward(*args, _round_f16, fit=False)
    assert not all(bool(torch.isfinite(t.float()).all()) for t in plain[:2])
    fitted = _tensor_core_backward(*args, _round_f16)
    for name, got, r in zip(("dq", "dk", "dv"), fitted, ref):
        assert bool(torch.isfinite(got.float()).all()), name
        excess, fro = _bwd_criteria(name, got, r, tols)
        assert excess <= 0.5 and fro <= 0.75, (name, excess, fro)


# the guard at its edges: a value of dS, then whether the packed test
# fires, the row's factor after the tile, and the value handed back (its
# f16 rounding at that factor, divided back)
GUARD_EDGES = [
    (32759.998046875, False, 1.0, 32752.0),   # rounds below 2^15
    (32760.0, True, 1.0, 32768.0),            # rounds to 2^15; fp32 not over
    (32768.0, True, 1.0, 32768.0),            # 2^15 itself: not over
    (32768.00390625, True, 0.5, 32768.0),     # just over 2^15 in fp32
    (65504.0, True, 0.5, 65504.0),            # f16's largest
    (65520.0, True, 0.5, 65536.0),            # rounds to inf in f16
    (float("inf"), True, 1.0, float("inf")),  # inf stays inf
]


@pytest.mark.parametrize("value,vote,mul,back", GUARD_EDGES)
def test_f16_guard_rule_at_its_edges(value, vote, mul, back):
    """One tile of two warps (32 rows of 64 values of 1.5), the edge value
    in row 3: the test fires for row 3 exactly where f16 rounding reaches
    2^15 (as the rounded value's magnitude and the packed bits say too),
    row 3's factor drops only where its fp32 value passes
    2^15 as well, its warp's other rows and the other warp keep factor 1
    and the plain rounding, and the next tile runs at the dropped factor
    (1000 there rounds as it does at factor 1: powers of two are exact)."""
    ds = torch.full((32, 128), 1.5)
    ds[3, 5] = value
    ds[3, 70] = 1000.0                   # the second tile, row 3
    y = ds[:, :64]
    assert _vote_rows(y).tolist() == [i == 3 and vote for i in range(32)]
    rounded = y.to(torch.float16).float().abs()
    assert _vote_rows(y).tolist() == (rounded >= KDS_MAX).any(-1).tolist()
    assert _f16_big(y).tolist() == _vote_rows(y).tolist()
    factors = []
    out = _fit_rows(ds, _round_f16, factors=factors)
    assert [f.tolist() for f in factors] == \
        [[mul if i == 3 else 1.0 for i in range(32)]] * 2
    assert float(out[3, 5]) == back
    plain = _round_f16(ds)
    rest = torch.ones_like(ds, dtype=torch.bool)
    rest[3, 5] = False
    assert torch.equal(out[rest], plain[rest])
    assert float(out[3, 70]) == 1000.0


def test_f16_guard_vote_is_necessary_for_a_drop():
    """Over a dense sweep of fp32 values around 2^15 and 65504 (and up to
    2^17), the test fires exactly where the value rounds to 2^15 or more
    in f16 (the packed bits say the same), and every value whose fp32
    magnitude passes 2^15 (the drop rule) fires it: the vote never hides
    a drop."""
    grid = torch.cat([torch.linspace(32700, 32800, 20001),
                      torch.linspace(65400, 65600, 20001),
                      torch.linspace(2.0 ** 14, 2.0 ** 17, 40001)])
    vals = torch.cat([grid, -grid])
    fires = _vote_rows(vals[:, None])
    rounded = vals.to(torch.float16).float().abs()
    assert fires.tolist() == (rounded >= KDS_MAX).tolist()
    assert fires.tolist() == _f16_big(vals[:, None]).tolist()
    assert bool(fires[vals.abs() > KDS_MAX].all())


@pytest.mark.parametrize("rows", [16, 40])
def test_f16_guard_is_the_plain_rounding_without_a_trigger(rows):
    """Where no tile's value rounds to 2^15 (the common path: the
    packed words go to the tensor cores as bf16's do), and where one
    rounds to 2^15 without passing it in fp32, the fitted dS equals the
    plain f16 rounding bit for bit."""
    rng = np.random.default_rng(rows)
    ds = torch.from_numpy((rng.standard_normal((1, 2, rows, 200)) * 3000)
                          .astype(np.float32))
    assert float(ds.abs().max()) < 32760.0
    assert torch.equal(_fit_rows(ds, _round_f16), _round_f16(ds))
    ds[0, 1, rows - 1, 150] = 32768.0
    ds[0, 0, 2, 10] = -32760.0
    assert torch.equal(_fit_rows(ds, _round_f16), _round_f16(ds))


@pytest.mark.parametrize("gain", [1.0, 300.0, 3000.0, 12000.0])
@pytest.mark.parametrize("causal", [True, False])
def test_f16_guard_matches_the_fp32_rule_wherever_rows_drop(causal, gain):
    """The test and vote decide only whether a warp looks at its fp32 row
    maxima, so dQ's and dK's operands equal the earlier design's
    (`_fit_rows_fp32`: the fp32 rule on every tile) bit for bit at every
    gain, also where rows drop their factor (the larger gains)."""
    n, d = 256, 64
    q, k, v = _f16((1, n, 2, d), seed=31)
    q = (q.float() * 2).to(torch.float16)
    (g,) = _f16((1, n, 2, d), seed=32, count=1, gain=gain)
    args, _ = _bwd_case(q, k, v, g, causal, 1.0 / math.sqrt(d))
    _, _, _, _, ds = tfa._bwd_probs(*args)
    drops = 0
    for rows in (ds, ds.transpose(-1, -2)):
        got = _fit_rows(rows, _round_f16)
        want = _fit_rows_fp32(rows, _round_f16)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        drops += int((rows.abs().amax(-1) > KDS_MAX).sum())
    assert (drops > 0) == (gain >= 12000.0), drops


def test_f16_criteria_are_bf16_s_scaled_by_the_unit_roundoff():
    """The f16 limits are bf16's with f16's unit roundoff (2^-11 against
    2^-9) and the subnormal floor on top."""
    v = torch.ones((1, 4, 1, 64), dtype=torch.float16)
    atol, rtol = tfa.flash_fwd_f16_tol(v)
    assert atol == 2 * (2.0 ** -11 + 4 * 2.0 ** -25)
    assert tfa.FLASH_FWD_F16_FRO_RTOL * 4 == tfa.FLASH_FWD_BF16_FRO_RTOL
    assert tfa.FLASH_BWD_F16_FRO_RTOL * 4 == tfa.FLASH_BWD_BF16_FRO_RTOL
    assert tfa.flash_fwd_tol(v) == (atol, rtol)
    assert tfa.flash_fwd_tol(v.bfloat16()) == tfa.flash_fwd_bf16_tol(v)
    assert tfa.flash_fwd_tol(v.float()) is None
