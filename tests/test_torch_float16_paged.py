"""Port parity: float16 in the paged decode step and the prompt scatter.

The paged decode kernel is instantiated for q (and out) of fp32, bf16 or
float16 over pools of any of those three or int8; the prompt scatter for
rows of the three types into pools of any of them or int8. Their plain
twins, which the CPU runs, against the JAX package on the same values:

  * one decode step (the write of this step's K and V rows, then the
    attention) for every pair with float16 on either side: pools bit for
    bit on every block but null block 0 (only the twins write it), the
    write a cast through fp32 with one rounding to nearest even, as the
    reference's ``.astype``; outputs within fp32 summation order (1e-5)
    where q is fp32, one rounding of the output (rtol 2e-3 in f16, 1e-2
    in bf16) otherwise;
  * a new value past f16's largest (65504) becomes inf in f16 pools, as in
    the reference;
  * int8 pools under f16 q: levels bit for bit, scales within fp32
    rounding, outputs within one f16 step;
  * the kernel's split arithmetic (`split_emulation`) over f16 pools
    against the JAX step;
  * the scatter: f16 rows into f16, fp32 and bf16 pools and fp32 / bf16
    rows into f16 pools, bit for bit with the JAX `scatter_prefill`; f16
    rows into int8 pools, levels and scales bit for bit; and the kernel's
    order of work (`kernel_emulation`, 8 values a 16-byte vector) against
    the twin on f16 rows.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.nn.functional.attention import \
    paged_decode_attention as j_paged
from paddle_tpu.serving.cache import scatter_prefill as j_scatter

from paddle_tpu_torch.kernels import prefill_scatter as ps
from paddle_tpu_torch.nn.functional import paged_decode_attention as t_paged
from paddle_tpu_torch.serving import scatter_prefill

from test_torch_int8_kv import _quant_state
from test_torch_paged_attention import split_emulation
from test_torch_prefill_scatter import (BS, ROW, _emulate_and_compare,
                                        _state)
from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

F16, BF16, F32 = torch.float16, torch.bfloat16, torch.float32
_J = {F32: jnp.float32, BF16: jnp.bfloat16, F16: jnp.float16}
OUT_TOL = {F32: dict(rtol=1e-5, atol=1e-5), BF16: dict(rtol=1e-2, atol=1e-2),
           F16: dict(rtol=2e-3, atol=2e-3)}
PAIRS = [(F16, F16), (F16, F32), (F16, BF16), (F32, F16), (BF16, F16)]


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(_J[t.dtype])


def _from_j(a, dtype):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)


def _bits(t):
    if t.dtype in (F16, BF16):
        return t.view(torch.int16)
    return t.view(torch.int32) if t.dtype == F32 else t


def _step_state(q_dtype, pool_dtype, seed, s=3, h=2, d=16, bs=4, m=5,
                gain=1.0):
    g = torch.Generator().manual_seed(seed)
    nb = 1 + s * m
    pools = [torch.randn((nb, bs, h, d), generator=g).to(pool_dtype)
             for _ in range(2)]
    q, kn, vn = ((torch.randn((s, 1, h, d), generator=g) * gain)
                 .to(q_dtype) for _ in range(3))
    tables = torch.arange(1, 1 + s * m, dtype=torch.int32).view(s, m)
    tables[1] = 0
    lens = torch.tensor([9, 0, 12], dtype=torch.int32)
    active = torch.tensor([True, False, True])
    return q, kn, vn, pools, tables, lens, active, bs


def _jax_step(q, kn, vn, kp, vp, tables, lens, active, bs):
    return j_paged(*(_jnp(t) for t in (q, kn, vn, kp, vp)),
                   *(jnp.asarray(t.numpy()) for t in (tables, lens, active)),
                   bs, kernel="reference")


@pytest.mark.parametrize("q_dtype, pool_dtype", PAIRS)
def test_decode_step_matches_jax_for_every_f16_pair(q_dtype, pool_dtype):
    q, kn, vn, (kp, vp), tables, lens, active, bs = _step_state(
        q_dtype, pool_dtype, seed=31)
    j_out, j_k, j_v = _jax_step(q, kn, vn, kp, vp, tables, lens, active, bs)
    t_k, t_v = kp.clone(), vp.clone()
    out, k_out, v_out = t_paged(q, kn, vn, t_k, t_v, tables, lens, active,
                                bs)
    assert out.dtype == q_dtype and k_out is t_k
    for got, want in ((t_k, j_k), (t_v, j_v)):
        want = _from_j(want, pool_dtype)
        assert torch.equal(_bits(got)[1:], _bits(want)[1:])
    rows = active.numpy()
    np.testing.assert_allclose(out.float().numpy()[rows],
                               np.asarray(j_out.astype(jnp.float32))[rows],
                               **OUT_TOL[q_dtype])


@pytest.mark.parametrize("q_dtype", [F32, BF16])
def test_write_past_the_f16_range_is_inf_as_in_jax(q_dtype):
    """K/V of fp32 or bf16 past 65504 are written into f16 pools as inf,
    as the reference's ``.astype(float16)`` rounds them."""
    q, kn, vn, (kp, vp), tables, lens, active, bs = _step_state(
        q_dtype, F16, seed=33, gain=4e4)
    _, j_k, j_v = _jax_step(q, kn, vn, kp, vp, tables, lens, active, bs)
    t_k, t_v = kp.clone(), vp.clone()
    t_paged(q, kn, vn, t_k, t_v, tables, lens, active, bs)
    assert bool(torch.isinf(t_k).any()) and bool(torch.isinf(t_v).any())
    for got, want in ((t_k, j_k), (t_v, j_v)):
        assert torch.equal(_bits(got)[1:], _bits(_from_j(want, F16))[1:])


def test_int8_decode_step_under_f16_q_matches_jax():
    rng = np.random.default_rng(35)
    s, h, d, bs, m = 3, 2, 16, 4, 5
    q, kp, vp, tables, _, ks, vs = _quant_state(s=s, h=h, d=d, bs=bs, m=m,
                                                seed=36)
    tables[1] = 0
    lens = np.asarray([9, 0, 12], np.int32)
    active = np.asarray([True, False, True])
    q16, kn, vn = (torch.from_numpy(a.astype(np.float32)).to(F16) for a in
                   (q[:, None], rng.standard_normal((s, 1, h, d)),
                    rng.standard_normal((s, 1, h, d))))
    j_out, j_k, j_v, j_ks, j_vs = j_paged(
        *(_jnp(t) for t in (q16, kn, vn)),
        *(jnp.asarray(a) for a in (kp, vp, tables, lens, active)), bs,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        kernel="reference")
    t_k, t_v, t_ks, t_vs = (torch.from_numpy(a.copy())
                            for a in (kp, vp, ks, vs))
    out = t_paged(q16, kn, vn, t_k, t_v, torch.from_numpy(tables),
                  torch.from_numpy(lens), torch.from_numpy(active), bs,
                  k_scales=t_ks, v_scales=t_vs)
    assert out[0].dtype == F16
    for got, want in ((t_k, j_k), (t_v, j_v)):
        np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])
    for got, want in ((t_ks, j_ks), (t_vs, j_vs)):
        np.testing.assert_allclose(got.numpy()[1:], np.asarray(want)[1:],
                                   rtol=1e-6, atol=0)
    np.testing.assert_allclose(out[0].float().numpy()[active],
                               np.asarray(j_out.astype(jnp.float32))[active],
                               **OUT_TOL[F16])


@pytest.mark.parametrize("q_dtype", [F16, F32])
def test_kernel_split_arithmetic_over_f16_pools_matches_jax(q_dtype):
    """`split_emulation` (the kernel's order of work) on f16 pools, after
    the twin's write, against the JAX step's output in fp32 (the
    emulation's output in q's dtype)."""
    q, kn, vn, (kp, vp), tables, lens, active, bs = _step_state(
        q_dtype, F16, seed=37)
    j_out, _, _ = _jax_step(q.float(), kn, vn, kp, vp, tables, lens, active,
                            bs)
    t_k, t_v = kp.clone(), vp.clone()
    t_paged(q, kn, vn, t_k, t_v, tables, lens, active, bs)
    emu = split_emulation(q[:, 0], t_k, t_v, tables,
                          torch.where(active, lens, 0), bs)
    rows = active.numpy()
    np.testing.assert_allclose(emu.float().numpy()[rows],
                               np.asarray(j_out)[rows, 0],
                               **OUT_TOL[q_dtype])


SCATTER_PAIRS = [(F16, F16), (F16, F32), (F16, BF16), (F32, F16),
                 (BF16, F16)]


@pytest.mark.parametrize("row_dtype, pool_dtype", SCATTER_PAIRS)
def test_prompt_scatter_matches_jax_for_every_f16_pair(row_dtype,
                                                       pool_dtype):
    g = torch.Generator().manual_seed(41)
    layers, nb, bs, h, d, t, length = 2, 9, 4, 2, 8, 16, 11
    kv = [torch.randn((t, h, d), generator=g).to(row_dtype)
          for _ in range(2 * layers)]
    pools = [torch.randn((layers, nb, bs, h, d), generator=g).to(pool_dtype)
             for _ in range(2)]
    row = torch.tensor([3, 7, 1, 5], dtype=torch.int32)
    jk, jv = j_scatter(_jnp(pools[0]), _jnp(pools[1]),
                       jnp.stack([_jnp(x) for x in kv[:layers]]),
                       jnp.stack([_jnp(x) for x in kv[layers:]]),
                       jnp.asarray(row.numpy()), length, bs)
    tk, tv = pools[0].clone(), pools[1].clone()
    ps.prefill_scatter(tk, tv, kv[:layers], kv[layers:], row,
                       torch.tensor(length, dtype=torch.int32), bs)
    for got, want in ((tk, jk), (tv, jv)):
        assert torch.equal(_bits(got)[:, 1:],
                           _bits(_from_j(want, pool_dtype))[:, 1:])


@pytest.mark.parametrize("length", (1, 15, 16, 17, 32))
def test_f16_rows_into_int8_pools_match_jax(length):
    k_rows, v_rows, (kp, vp), (ks, vs) = _state(F16, True, seed=60 + length)
    row = torch.tensor(ROW, dtype=torch.int32)
    stack = [jnp.stack([_jnp(x.contiguous()) for x in rows])
             for rows in (k_rows, v_rows)]
    want = j_scatter(jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
                     *stack, jnp.asarray(row.numpy()), jnp.int32(length),
                     BS, jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()))
    got = scatter_prefill(kp, vp, k_rows, v_rows, row, length, BS,
                          k_scales=ks, v_scales=vs)
    for g_t, w_t in zip(got, want):
        np.testing.assert_array_equal(g_t.numpy()[:, 1:],
                                      np.asarray(w_t)[:, 1:])


@pytest.mark.parametrize("length", (1, 16, 17, 32))
@pytest.mark.parametrize("int8", [False, True])
def test_scatter_kernel_emulation_matches_twin_on_f16_rows(int8, length):
    """The kernel's order of work on f16 rows (8 values a 16-byte vector;
    the amax on packed f16 pairs is exact, as the emulation's fp32 max)
    against the twin: every block but 0 equal, each row value read once."""
    k_rows, v_rows, pools, scales = _state(F16, int8, seed=70 + length)
    reads = _emulate_and_compare(k_rows, v_rows, pools, scales, ROW, length,
                                 BS, vec=8)
    if int8:
        for r in reads:
            assert np.all(r[:, :length] == 1)
