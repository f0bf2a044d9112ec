"""Port parity: paddle_tpu_torch paged decode attention vs the JAX package.

The edge cases of tests/test_kernel_tier.py `_paged_state` (a fresh slot
with zero history, lengths at an exact block boundary, a long history, an
inactive slot whose table points at null block 0) go through the JAX
`paged_decode_attention` with the Pallas kernel in interpret mode and with
the dense reference, and through the port on CPU tensors (where the wrapper
takes its plain twin `paged_decode_reference`).

Tolerances: active slots' outputs to 1e-5 (fp32; blockwise online softmax
vs dense softmax differ in summation order only); the pools after the
write are bit-identical (both sides copy the same fp32 values into the same
places).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.nn.functional.attention import \
    paged_decode_attention as j_paged

from paddle_tpu_torch.kernels.paged_attention import (
    paged_attention, paged_decode_reference)
from paddle_tpu_torch.nn.functional import paged_decode_attention as t_paged
from paddle_tpu_torch.nn.functional.attention import _dense_gather_attention

TOL = dict(rtol=1e-5, atol=1e-5)


def _paged_state(S=4, H=3, D=16, bs=4, M=6, lens=(0, 4, 8, 23),
                 active=(True, True, True, True), seed=0):
    """Numpy twin of tests/test_kernel_tier.py `_paged_state`: per-slot
    dense-prefix tables over disjoint pool blocks, random history."""
    rng = np.random.default_rng(seed)
    nb = S * M + 1
    mk = lambda sh: rng.standard_normal(sh).astype(np.float32)
    q, kn, vn = mk((S, 1, H, D)), mk((S, 1, H, D)), mk((S, 1, H, D))
    kp, vp = mk((nb, bs, H, D)), mk((nb, bs, H, D))
    tables = np.stack([1 + s * M + np.arange(M) for s in range(S)]) \
        .astype(np.int32)
    return dict(q=q, kn=kn, vn=vn, kp=kp, vp=vp, tables=tables,
                lens=np.asarray(lens, np.int32),
                active=np.asarray(active, bool))


def _jax(st, bs, variant):
    out, kp, vp = j_paged(
        jnp.asarray(st["q"]), jnp.asarray(st["kn"]), jnp.asarray(st["vn"]),
        jnp.asarray(st["kp"]), jnp.asarray(st["vp"]),
        jnp.asarray(st["tables"]), jnp.asarray(st["lens"]),
        jnp.asarray(st["active"]), bs, kernel=variant,
        interpret=variant == "pallas")
    return np.asarray(out), np.asarray(kp), np.asarray(vp)


def _port(st, bs):
    kp = torch.from_numpy(st["kp"].copy())
    vp = torch.from_numpy(st["vp"].copy())
    out, kp2, vp2 = t_paged(
        torch.from_numpy(st["q"]), torch.from_numpy(st["kn"]),
        torch.from_numpy(st["vn"]), kp, vp, torch.from_numpy(st["tables"]),
        torch.from_numpy(st["lens"]), torch.from_numpy(st["active"]), bs)
    assert kp2 is kp and vp2 is vp          # written in place
    return out.numpy(), kp.numpy(), vp.numpy()


def _assert_parity(st, bs, variant):
    j_out, j_k, j_v = _jax(st, bs, variant)
    t_out, t_k, t_v = _port(st, bs)
    act = st["active"]
    np.testing.assert_allclose(t_out[act], j_out[act], **TOL)
    assert np.isfinite(t_out).all()
    np.testing.assert_array_equal(t_k, j_k)
    np.testing.assert_array_equal(t_v, j_v)


VARIANTS = ("pallas", "reference")


@pytest.mark.parametrize("variant", VARIANTS)
def test_core_parity(variant):
    _assert_parity(_paged_state(bs=4), 4, variant)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("length", [4, 8, 20])
def test_seq_len_at_exact_block_boundary(variant, length):
    """len == k*bs: the new token opens a fresh block (offset 0 of table
    entry k) and attention spans the boundary."""
    st = _paged_state(S=2, M=6, bs=4, lens=(length, length - 1),
                      active=(True, True), seed=length)
    _assert_parity(st, 4, variant)


@pytest.mark.parametrize("variant", VARIANTS)
def test_inactive_slot_with_null_table(variant):
    st = _paged_state(S=3, M=4, bs=4, lens=(7, 0, 5),
                      active=(True, False, True))
    st["tables"][1] = 0                       # the engine's cleared slot
    _assert_parity(st, 4, variant)


def test_long_history_head_dim_64():
    """The serving head dim and a history spanning many chunks of the
    plain version's blockwise loop."""
    st = _paged_state(S=3, H=2, D=64, bs=16, M=40, lens=(639, 300, 17),
                      active=(True, True, True), seed=4)
    _assert_parity(st, 16, "reference")


def test_kernel_twin_against_dense_gather():
    """`paged_attention` on CPU tensors (the plain twin) against the dense
    gather oracle, with a chunk size that leaves a padded last chunk."""
    st = _paged_state(S=4, H=2, D=8, bs=4, M=7, lens=(0, 3, 12, 27))
    args = [torch.from_numpy(st[k][:, 0] if k == "q" else st[k])
            for k in ("q", "kp", "vp", "tables", "lens")]
    out = paged_attention(*args, 4)
    dense = _dense_gather_attention(*args, 4)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **TOL)
    chunked = paged_decode_reference(*args, 4, chunk_blocks=3)
    np.testing.assert_allclose(chunked.numpy(), dense.numpy(), **TOL)


def test_bf16_tracks_fp32():
    """bf16 inputs: scores, softmax and PV still accumulate in fp32, so the
    bf16 result tracks the all-fp32 one to input rounding (~1e-2)."""
    st = _paged_state(S=2, H=2, D=8, M=16, bs=4, lens=(60, 31),
                      active=(True, True))
    args32 = [torch.from_numpy(st[k][:, 0] if k == "q" else st[k])
              for k in ("q", "kp", "vp", "tables", "lens")]
    args16 = [a.to(torch.bfloat16) if a.is_floating_point() else a
              for a in args32]
    out16 = paged_attention(*args16, 4)
    out32 = _dense_gather_attention(*args32, 4)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(),
                               rtol=0.0, atol=2e-2)
