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

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.nn.functional.attention import \
    paged_decode_attention as j_paged

from paddle_tpu_torch.kernels.paged_attention import (
    MAX_SPAN_BLOCKS, MAX_SPLITS, SPAN_TOKENS, paged_attention,
    paged_decode_append, paged_decode_reference, split_plan)
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


# ---------------------------------------------------------------------------
# the kernel's split of each slot's context across CTAs (split-K) and the
# combine of their partial softmaxes, emulated in plain torch
# ---------------------------------------------------------------------------

# fp32: the emulation sums the same fp32 terms as the Pallas kernel and the
# blockwise reference, per span and then across spans, so only the
# summation order differs (~1e-7 relative at these sizes), held at 1e-5
SPLIT_TOL = dict(rtol=1e-5, atol=1e-5)


def split_emulation(q, k_pool, v_pool, tables, lens, bs, k_scales=None,
                    v_scales=None):
    """The kernel's arithmetic in plain torch: `split_plan`'s n_split CTAs
    per (slot, head), split i taking table entries [i e, (i + 1) e) with e
    = min(span_blocks, ceil(ceil((lens[s] + 1) / n_split) / bs)); one
    partial (max, sum, acc) per split holding a position p <= lens[s]
    (later splits are never read), merged in split order as split 0 does.
    q ``[S, H, D]``; int8 pools with their scales are dequantized as
    ``k * (scale * (1 / 127))``."""
    s, h, d = q.shape
    m = tables.shape[1]
    span_blocks, n_split = split_plan(m, bs)
    q32 = q.float() * (1.0 / np.sqrt(d))
    out = torch.empty((s, h, d), dtype=torch.float32)
    for si in range(s):
        last = min(max(int(lens[si]), 0), m * bs - 1)
        per_split = -(-(last + 1) // n_split)
        span = min(span_blocks, -(-per_split // bs)) * bs
        n_live = last // span + 1
        assert n_live <= n_split
        parts = []
        for sp in range(n_live):
            pos = torch.arange(sp * span, min(last, (sp + 1) * span - 1) + 1)
            blk = tables[si, pos // bs].long()
            off = pos % bs
            kx, vx = k_pool[blk, off].float(), v_pool[blk, off].float()
            if k_scales is not None:
                kx = kx * (k_scales[blk] * (1.0 / 127))[..., None]
                vx = vx * (v_scales[blk] * (1.0 / 127))[..., None]
            sc = torch.einsum("hd,thd->ht", q32[si], kx)
            mx = sc.amax(dim=-1)
            p = torch.exp(sc - mx[:, None])
            parts.append((mx, p.sum(dim=-1), torch.einsum("ht,thd->hd", p,
                                                          vx)))
        m_all = parts[0][0]
        for mx, _, _ in parts[1:]:
            m_all = torch.maximum(m_all, mx)
        l_all = torch.zeros(h)
        acc = torch.zeros(h, d)
        for mx, l, a in parts:
            w = torch.exp(mx - m_all)
            l_all = l_all + l * w
            acc = acc + a * w[:, None]
        out[si] = acc / torch.clamp(l_all, min=1e-30)[:, None]
    return out.to(q.dtype)


SPLIT_VARIANTS = ("pallas", "blockwise")


def _split_parity(st, bs, variant):
    """JAX's decode step (write, then attention) against the emulation on
    the pools after the write, and against the port on CPU tensors."""
    j_out, j_k, j_v = _jax(st, bs, variant)
    act = st["active"]
    emu = split_emulation(torch.from_numpy(st["q"][:, 0]),
                          torch.from_numpy(np.array(j_k)),
                          torch.from_numpy(np.array(j_v)),
                          torch.from_numpy(st["tables"]),
                          torch.from_numpy(np.where(act, st["lens"], 0)), bs)
    assert np.isfinite(emu.numpy()).all()
    np.testing.assert_allclose(emu.numpy()[act], j_out[act][:, 0],
                               **SPLIT_TOL)
    _assert_parity(st, bs, variant)


# bs 4, M = 160: 3 splits of at most 64 entries (256 tokens). A slot's
# live positions are shared evenly in whole entries, so the boundaries
# move with the length: 3 live splits from lens 8 on (9 positions, spans
# of 1 entry), spans growing by an entry every 12 positions, to 54
# entries at lens 639
@pytest.mark.parametrize("variant", SPLIT_VARIANTS)
@pytest.mark.parametrize("lens", [
    (7, 8, 9),             # 2 live splits, then 3 (1 position in the last)
    (11, 12, 13),          # spans of 1 entry, then of 2
    (383, 384, 385),       # spans of 32 entries, then of 33
    (10, 639, 0),          # all M blocks (3 x 54 entries); lens 0
])
def test_split_boundaries_match_jax(variant, lens):
    assert split_plan(160, 4) == (64, 3)
    st = _paged_state(S=3, H=1, D=16, bs=4, M=160, lens=lens,
                      active=(True, True, True), seed=sum(lens))
    _split_parity(st, 4, variant)


@pytest.mark.parametrize("variant", SPLIT_VARIANTS)
def test_split_inactive_slot_with_null_table(variant):
    """lens 0 with a null table row: one live split reading block 0,
    finite garbage out."""
    st = _paged_state(S=3, H=1, D=16, bs=4, M=160, lens=(300, 0, 639),
                      active=(True, False, True), seed=7)
    st["tables"][1] = 0
    _split_parity(st, 4, variant)


@pytest.mark.parametrize("variant", SPLIT_VARIANTS)
def test_split_head_dim_128(variant):
    """D = 128, the other head dim the kernel is built for, at bs 16:
    3 splits of at most 16 entries in M = 40."""
    assert split_plan(40, 16) == (16, 3)
    st = _paged_state(S=2, H=1, D=128, bs=16, M=40, lens=(95, 639),
                      active=(True, True), seed=12)
    _split_parity(st, 16, variant)


@pytest.mark.parametrize("shape", [
    (64, 16),       # the serving path: 4 splits of at most 16 entries
    (7, 4),         # a span longer than the table: one split
    (50, 3),        # a block size that divides no span
    (2048, 16),     # a 32K context: 8 splits of 256 entries
    (4096, 16),     # the longest table: 8 splits of 512 entries
])
def test_split_plan_covers_each_position_once(shape):
    """Every position 0 .. M * bs - 1 falls in exactly one span of whole
    table entries, at most MAX_SPLITS spans (one cluster) of at most
    MAX_SPAN_BLOCKS entries, SPAN_TOKENS a span where MAX_SPLITS of those
    cover the table."""
    m, bs = shape
    span, n_split = split_plan(*shape)
    assert 1 <= span <= min(m, MAX_SPAN_BLOCKS)
    assert 1 <= n_split <= MAX_SPLITS and n_split == -(-m // span)
    owner = torch.arange(m * bs) // (span * bs)
    assert owner.min() == 0 and owner.max() == n_split - 1
    assert torch.bincount(owner).sum() == m * bs
    assert (n_split - 1) * span < m <= n_split * span
    assert span == min(m, max(1, SPAN_TOKENS // bs, -(-m // MAX_SPLITS)))


def test_split_plan_refuses_tables_past_its_spans():
    with pytest.raises(ValueError):
        split_plan(MAX_SPLITS * MAX_SPAN_BLOCKS + 1, 16)


def test_split_plan_needs_no_lengths():
    """The plan's inputs are shapes only, and the wrappers' launch paths
    (the kernel alone, and with the decode write) read nothing back from
    the device (no sync a CUDA graph could not capture)."""
    assert list(inspect.signature(split_plan).parameters) == [
        "max_blocks", "block_size"]
    src = (inspect.getsource(paged_attention) + inspect.getsource(split_plan)
           + inspect.getsource(paged_decode_append))
    for read in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(lens",
                 "synchronize("):
        assert read not in src, read


def test_split_emulation_matches_twin_at_the_serving_shape():
    """The emulation against the port's plain twin at the serving path's
    split (bs 16, 4 splits of at most 256 tokens, D = 64), bf16 pools,
    ragged lengths: a full context, 216 positions (4 spans of 4 entries)
    and 64 / 65 positions (spans of 1 entry, then 2)."""
    st = _paged_state(S=4, H=2, D=64, bs=16, M=64,
                      lens=(1023, 215, 63, 64), seed=9)
    args = [torch.from_numpy(st[k][:, 0] if k == "q" else st[k])
            for k in ("q", "kp", "vp", "tables", "lens")]
    args = [a.to(torch.bfloat16) if a.is_floating_point() else a
            for a in args]
    assert split_plan(64, 16) == (16, 4)
    emu = split_emulation(*args, 16)
    twin = paged_decode_reference(*args, 16)
    # both compute in fp32 from the same bf16 inputs and round the output
    # to bf16 once: one bf16 step (rtol 2^-7) apart at most
    np.testing.assert_allclose(emu.float().numpy(), twin.float().numpy(),
                               rtol=8e-3, atol=1e-3)
