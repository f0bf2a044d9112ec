"""Port parity: the serving decode step's write and attention in one call
(`kernels.paged_attention.paged_decode_append`).

  * its CPU route, the plain composition (`kv_append_reference`, then
    `paged_decode_reference` with ``where(active, seq_lens, 0)``), against
    the JAX `paged_decode_attention` with the Pallas kernel in interpret
    mode and with the dense reference, on the same numpy inputs, for fp32,
    bf16 and int8 pools (fp32 and bf16 rows): pools and scales bit for bit
    on every block but null block 0, active slots' outputs within TOL. q,
    k_new and v_new are the strided views of one fused QKV projection, as
    the model passes them;
  * `fused_emulation`, the CUDA kernel's order of work in numpy (the
    split plan of `split_plan`, the write by the last live split before
    that split's reads, the one-pass int8 requantization, inactive slots
    skipped) against the twin composition: pools bit for bit on blocks
    1.., block 0 untouched, outputs within TOL, at lengths on block
    boundaries and at the table's end, at two split shapes;
  * the owner of the write: for every length of a table, exactly the last
    live split holds the write position, split 0 for a context within one
    table entry, and no other live split holds the write block;
  * the refusals: of the contract on both routes (mixed types, scales
    without int8 pools), of the kernel on its route (q with an inner
    stride other than 1, misaligned q rows, an int8 block slice too large
    for the one-pass write), reached with meta tensors (shapes, strides
    and offsets without storage): a well-formed meta call passes every
    check and stops at the card check;
  * the model's decode step calls `paged_decode_append` once a layer.

Block 0 is left out of every pool comparison: the twin writes inactive
slots' rows there (duplicate targets, as the reference does), the kernel
skips them, and nothing reads block 0 unmasked.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.nn.functional.attention import \
    paged_decode_attention as j_paged

from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels.kv_append import kv_append_reference
from paddle_tpu_torch.kernels.paged_attention import (
    MAX_INT8_BLOCK_LEVELS, paged_decode_append, paged_decode_reference,
    split_plan)
from paddle_tpu_torch.nn.functional import attention as t_attention
from paddle_tpu_torch.serving import LLMEngine

# active slots' outputs. fp32: blockwise online softmax, a dense softmax
# or the split's partials over the same fp32 values differ in summation
# order only (1e-5). bf16: both sides compute in fp32 from the same bf16
# values and round the output to bf16 once: one bf16 step (2^-8 of the
# value) apart at most, rtol 8e-3; atol 1e-3 only absorbs values near 0
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=8e-3, atol=1e-3)}
KINDS = ("float32", "bfloat16", "int8_f32_rows", "int8_bf16_rows")
F32 = np.float32


def _rows_dtype(kind):
    return torch.bfloat16 if "bf16" in kind or kind == "bfloat16" \
        else torch.float32


def _state(kind, lens, active, s, h, d, bs, m, cleared=(), seed=0):
    """Numpy inputs: one fused projection qkv [S, 3, H, D] (K and V rows
    scaled per slot, so some int8 blocks' scales grow and some shrink),
    pools holding a previous tenant's data (int8: random levels under
    scales mostly larger than the new rows), dense-prefix tables over
    disjoint blocks; the rows of `cleared` slots point at null block 0."""
    rng = np.random.default_rng(seed)
    gain = rng.choice(np.asarray([0.01, 0.5, 3.0, 10.0], F32), s)
    qkv = rng.standard_normal((s, 3, h, d)).astype(F32)
    qkv[:, 1:] *= gain[:, None, None, None]
    nb = 1 + s * m
    tables = np.stack([1 + i * m + np.arange(m) for i in range(s)]) \
        .astype(np.int32)
    tables[list(cleared)] = 0
    st = dict(qkv=qkv, tables=tables, lens=np.asarray(lens, np.int32),
              active=np.asarray(active, bool))
    if kind.startswith("int8"):
        st["k_pool"], st["v_pool"] = (
            rng.integers(-127, 128, (nb, bs, h, d)).astype(np.int8)
            for _ in range(2))
        st["k_scales"], st["v_scales"] = (
            rng.uniform(0.05, 4.0, (nb, h)).astype(F32) for _ in range(2))
    else:
        st["k_pool"], st["v_pool"] = (
            rng.standard_normal((nb, bs, h, d)).astype(F32)
            for _ in range(2))
    return st


def _torch_args(st, kind):
    """The state as torch tensors: q, k_new, v_new the strided views of
    the projection in the rows' type, fresh copies of the pools (fp pools
    in the rows' type) and scales."""
    rows = _rows_dtype(kind)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).clone()
         for k, v in st.items()}
    t["q"], t["k_new"], t["v_new"] = t.pop("qkv").to(rows).unbind(1)
    if not kind.startswith("int8"):
        t["k_pool"], t["v_pool"] = (t[k].to(rows) for k in ("k_pool",
                                                             "v_pool"))
    return t


def _call(t, bs):
    return paged_decode_append(t["q"], t["k_new"], t["v_new"], t["k_pool"],
                               t["v_pool"], t["tables"], t["lens"],
                               t["active"], bs, t.get("k_scales"),
                               t.get("v_scales"))


def _written(t):
    return [t[k] for k in ("k_pool", "v_pool", "k_scales", "v_scales")
            if k in t]


def _twin(st, kind, bs):
    """The twin composition on fresh copies: ``(out, written tensors)``."""
    t = _torch_args(st, kind)
    kv_append_reference(t["k_new"], t["v_new"], t["k_pool"], t["v_pool"],
                        t["tables"], t["lens"], t["active"], bs,
                        t.get("k_scales"), t.get("v_scales"))
    out = paged_decode_reference(t["q"], t["k_pool"], t["v_pool"],
                                 t["tables"],
                                 torch.where(t["active"], t["lens"], 0), bs,
                                 t.get("k_scales"), t.get("v_scales"))
    return out, _written(t)


# ---------------------------------------------------------------------------
# the CPU route against the JAX decode step
# ---------------------------------------------------------------------------

PS, PH, PD, PBS, PM = 4, 2, 16, 4, 6          # positions 0 .. 23
PARITY_CASES = {
    # write offsets 0, bs - 1 and mid-block
    "offsets": ([0, 3, 5, 10], [True] * 4, ()),
    # new blocks at boundaries, the table's last position
    "boundary_and_end": ([4, 8, 23, 12], [True] * 4, ()),
    # an inactive slot with a live table row and one with a cleared row
    "inactive": ([7, 9, 0, 20], [True, False, True, False], (3,)),
}


def _jax_step(st, kind, variant):
    rows = jnp.bfloat16 if _rows_dtype(kind) == torch.bfloat16 \
        else jnp.float32
    q, k_new, v_new = (jnp.asarray(st["qkv"][:, i:i + 1]).astype(rows)
                       for i in range(3))
    if kind.startswith("int8"):
        pools = (jnp.asarray(st["k_pool"]), jnp.asarray(st["v_pool"]))
        scales = dict(k_scales=jnp.asarray(st["k_scales"]),
                      v_scales=jnp.asarray(st["v_scales"]))
    else:
        pools = (jnp.asarray(st["k_pool"]).astype(rows),
                 jnp.asarray(st["v_pool"]).astype(rows))
        scales = {}
    out = j_paged(q, k_new, v_new, *pools, jnp.asarray(st["tables"]),
                  jnp.asarray(st["lens"]), jnp.asarray(st["active"]), PBS,
                  kernel=variant, interpret=variant == "pallas", **scales)
    return (np.asarray(out[0].astype(jnp.float32))[:, 0],
            [np.asarray(a).astype(F32) for a in out[1:]])


@pytest.mark.parametrize("variant", ["pallas", "reference"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_cpu_route_matches_jax_decode_step(case, kind, variant):
    lens, active, cleared = PARITY_CASES[case]
    st = _state(kind, lens, active, PS, PH, PD, PBS, PM, cleared,
                seed=len(case) + len(kind))
    t = _torch_args(st, kind)
    assert not t["q"].is_contiguous()           # the fused projection's view
    out = _call(t, PBS)
    j_out, j_written = _jax_step(st, kind, variant)
    act = st["active"]
    assert out.dtype == _rows_dtype(kind) and out.shape == (PS, PH, PD)
    np.testing.assert_allclose(out.float().numpy()[act], j_out[act],
                               **TOL[out.dtype])
    assert np.isfinite(out.float().numpy()).all()
    for got, want in zip(_written(t), j_written):
        np.testing.assert_array_equal(got.float().numpy()[1:], want[1:])


def test_cpu_route_takes_any_strides():
    """The plain composition reads q, k_new and v_new at any strides: an
    inner stride of 2 gives what contiguous copies give."""
    st = _state("int8_bf16_rows", [5, 9, 0, 17], [True, True, False, True],
                PS, PH, PD, PBS, PM, seed=3)
    a, b = _torch_args(st, "int8_bf16_rows"), _torch_args(st,
                                                          "int8_bf16_rows")
    for k in ("q", "k_new", "v_new"):
        wide = torch.zeros((PS, PH, 2 * PD), dtype=b[k].dtype)
        wide[..., ::2] = b[k]
        b[k] = wide[..., ::2]
        assert b[k].stride(2) == 2
    out_a, out_b = _call(a, PBS), _call(b, PBS)
    assert torch.equal(out_a, out_b)
    for x, y in zip(_written(a), _written(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the kernel's order of work, emulated in numpy
# ---------------------------------------------------------------------------

def _plan(length, m, bs):
    """The kernel's split of one slot of effective length `length`:
    ``(last_pos, span_blocks, span, n_live)`` as each CTA computes it."""
    span_max, n_split = split_plan(m, bs)
    last_pos = min(max(length, 0), m * bs - 1)
    per_split = (last_pos + n_split) // n_split
    span_blocks = min(span_max, -(-per_split // bs))
    span = span_blocks * bs
    return last_pos, span_blocks, span, last_pos // span + 1


def _write_rows(k_new, v_new, k_pool, v_pool, k_scales, v_scales, s, h, blk,
                off):
    """The owner's write of head h of slot s: fp pools take the rows; an
    int8 block slice is requantized in one pass over raw levels read once
    (x recomputed from them for the amax and the new levels), in the
    kernel's order of operations. Returns the new scales times 1/127
    (staged by the kernel for its span), or None."""
    if k_scales is None:
        k_pool[blk, off, h] = k_new[s, h]
        v_pool[blk, off, h] = v_new[s, h]
        return None
    c, eps = F32(1.0 / 127.0), F32(1e-8)
    staged = []
    for pool, scales, new in ((k_pool, k_scales, k_new),
                              (v_pool, v_scales, v_new)):
        bs = pool.shape[1]
        raw = pool[blk, :, h].copy()                 # every load first
        deq = F32(scales[blk, h]) * c

        def value():
            x = np.zeros(raw.shape, F32)
            x[:off] = raw[:off].astype(F32) * deq
            x[off] = new[s, h]
            return x

        new_sc = max(np.abs(value()).max(), eps)
        r = F32(127.0) / new_sc
        assert raw.shape[0] == bs
        pool[blk, :, h] = np.clip(np.rint(value() * r), -127, 127) \
            .astype(np.int8)
        scales[blk, h] = new_sc
        staged.append(F32(new_sc) * F32(1.0 / 127.0))
    return staged


def fused_emulation(q, k_new, v_new, k_pool, v_pool, tables, lens, active,
                    bs, k_scales=None, v_scales=None):
    """The fused kernel's order of work in numpy fp32, in place, one CTA
    (slot, head, split) at a time: the effective length ``active ? lens :
    0``; `split_plan`'s split; the last live split writes first, for an
    active slot whose position lies inside its table (inactive slots
    write nothing), then every live split reads its span (the owner's
    after its write, with its staged scales) into a partial (max, sum,
    acc); the partials merge in split order. Returns out [S, H, D]."""
    s_n, h_n, d = q.shape
    m = tables.shape[1]
    n_split = split_plan(m, bs)[1]
    nb = k_pool.shape[0]
    out = np.zeros((s_n, h_n, d), F32)
    for s in range(s_n):
        length = int(lens[s]) if active[s] else 0
        last_pos, span_blocks, span, n_live = _plan(length, m, bs)
        assert n_live <= n_split
        for h in range(h_n):
            parts = []
            for split in range(n_live):
                entries = tables[s, split * span_blocks:
                                 (split + 1) * span_blocks]
                staged, entry = None, length // bs - split * span_blocks
                if active[s] and length == last_pos and split == n_live - 1:
                    blk = int(entries[entry])
                    if 0 <= blk < nb:
                        staged = _write_rows(k_new, v_new, k_pool, v_pool,
                                             k_scales, v_scales, s, h, blk,
                                             length % bs)
                pos = np.arange(split * span,
                                min(last_pos, (split + 1) * span - 1) + 1)
                idx = pos // bs - split * span_blocks
                blk = entries[idx]
                kx = k_pool[blk, pos % bs, h].astype(F32)
                vx = v_pool[blk, pos % bs, h].astype(F32)
                if k_scales is not None:
                    ks = k_scales[blk, h] * F32(1.0 / 127.0)
                    vs = v_scales[blk, h] * F32(1.0 / 127.0)
                    if staged is not None:       # the write block's entry
                        ks[idx == entry], vs[idx == entry] = staged
                    kx, vx = kx * ks[:, None], vx * vs[:, None]
                sc = kx @ (q[s, h].astype(F32) * F32(1.0 / np.sqrt(d)))
                mx = sc.max()
                p = np.exp(sc - mx)
                parts.append((mx, p.sum(), p @ vx))
            m_all = max(mx for mx, _, _ in parts)
            l_all, acc = F32(0), np.zeros(d, F32)
            for mx, l, a in parts:
                w = np.exp(F32(mx - m_all))
                l_all = l_all + l * w
                acc = acc + a * w
            out[s, h] = acc / max(l_all, F32(1e-30))
    return out


# (block size, table entries, head dim): 3 splits of at most 64 entries;
# the serving path's 4 splits of at most 16 entries
EMU_SHAPES = {"bs4_m160": (4, 160, 16), "bs16_m64": (16, 64, 64)}
# per shape, (lens, active, cleared rows) of 5 slots: offsets 0 and bs - 1
# within the first entry (the owner is split 0), block boundaries, a
# mid-block position, the table's last position; inactive slots with a
# live and with a cleared row
EMU_CASES = {
    ("bs4_m160", "boundaries"): ([0, 3, 8, 639, 384], [True] * 5, ()),
    ("bs4_m160", "inactive"): ([383, 9, 0, 4, 101],
                               [True, False, False, True, True], (2,)),
    ("bs16_m64", "boundaries"): ([0, 15, 16, 1023, 200], [True] * 5, ()),
    ("bs16_m64", "inactive"): ([37, 500, 37, 63, 64],
                               [True, False, False, True, True], (2,)),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,case", sorted(EMU_CASES))
def test_fused_emulation_matches_twin(shape, case, kind):
    bs, m, d = EMU_SHAPES[shape]
    lens, active, cleared = EMU_CASES[shape, case]
    st = _state(kind, lens, active, 5, 2, d, bs, m, cleared,
                seed=bs + len(case) + len(kind))
    want_out, want = _twin(st, kind, bs)
    emu = {k: (v.float().numpy().copy() if v.dtype == torch.bfloat16
               else v.numpy().copy())
           for k, v in _torch_args(st, kind).items()}
    before = {k: v.copy() for k, v in emu.items()}
    out = fused_emulation(emu["q"], emu["k_new"], emu["v_new"],
                          emu["k_pool"], emu["v_pool"], emu["tables"],
                          emu["lens"], emu["active"], bs,
                          emu.get("k_scales"), emu.get("v_scales"))
    keys = [k for k in ("k_pool", "v_pool", "k_scales", "v_scales")
            if k in emu]
    for k, w in zip(keys, want):
        np.testing.assert_array_equal(emu[k][1:].astype(F32),
                                      w.float().numpy()[1:])
        np.testing.assert_array_equal(emu[k][0], before[k][0])
    rows = _rows_dtype(kind)
    got = torch.from_numpy(out).to(rows).float().numpy()
    act = st["active"]
    np.testing.assert_allclose(got[act], want_out.float().numpy()[act],
                               **TOL[rows])


@pytest.mark.parametrize("m,bs", [(64, 16), (160, 4), (7, 4), (50, 3)])
def test_owner_is_the_last_live_split(m, bs):
    """Exactly one live split holds each write position: the last one,
    split 0 when the context lies within one table entry; no other live
    split's span holds the write block's table entry."""
    for length in range(m * bs):
        last_pos, span_blocks, span, n_live = _plan(length, m, bs)
        assert last_pos == length
        holders = [i for i in range(n_live)
                   if i * span_blocks <= length // bs < (i + 1) * span_blocks]
        assert holders == [n_live - 1], (length, holders)
        if length < bs:
            assert n_live == 1
    # a position past the table: the clamped plan holds no write position
    assert _plan(m * bs, m, bs)[0] == m * bs - 1


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

RS, RH, RD, RBS, RM = 2, 2, 64, 16, 4


def _refusal_args(device, pool_dtype=torch.float32, bs=RBS):
    """A well-formed call on `device` (meta: shapes, strides and offsets
    without storage): q, k_new, v_new views of one [S, 3, H, D]
    projection, fp32 rows."""
    qkv = torch.zeros((RS, 3, RH, RD), device=device)
    q, k, v = qkv.unbind(1)
    nb = 1 + RS * RM
    pools = [torch.zeros((nb, bs, RH, RD), device=device, dtype=pool_dtype)
             for _ in range(2)]
    t = dict(q=q, k_new=k, v_new=v, k_pool=pools[0], v_pool=pools[1],
             tables=torch.zeros((RS, RM), dtype=torch.int32, device=device),
             lens=torch.zeros(RS, dtype=torch.int32, device=device),
             active=torch.ones(RS, dtype=torch.bool, device=device))
    if pool_dtype == torch.int8:
        t["k_scales"], t["v_scales"] = (torch.ones((nb, RH), device=device)
                                        for _ in range(2))
    return t


def _strided_q(t, inner):
    wide = torch.zeros((RS, RH, inner * RD), device=t["q"].device)
    t["q"] = wide[..., ::inner]


def _offset_q(t):
    flat = torch.zeros(RS * RH * RD + 1, device=t["q"].device)
    t["q"] = flat[1:].view(RS, RH, RD)


def _slot_stride_q(t):
    flat = torch.zeros(RS * (RH * RD + 1), device=t["q"].device)
    t["q"] = flat.as_strided((RS, RH, RD), (RH * RD + 1, RD, 1))


# name -> (error, edit of a well-formed call, int8 pools, block size)
CONTRACT_REFUSALS = {
    "mixed_types": (TypeError, lambda t: t.update(
        q=t["q"].to(torch.bfloat16)), torch.float32, RBS),
    "scales_with_fp_pools": (TypeError, lambda t: t.update(
        k_scales=torch.ones((1 + RS * RM, RH), device=t["q"].device),
        v_scales=torch.ones((1 + RS * RM, RH), device=t["q"].device)),
        torch.float32, RBS),
}
KERNEL_REFUSALS = {
    "q_inner_stride": (ValueError, lambda t: _strided_q(t, 2),
                       torch.float32, RBS),
    "q_misaligned_base": (ValueError, _offset_q, torch.float32, RBS),
    "q_misaligned_slot_stride": (ValueError, _slot_stride_q, torch.float32,
                                 RBS),
    "int8_block_slice_too_large": (
        ValueError, lambda t: None, torch.int8,
        2 * MAX_INT8_BLOCK_LEVELS // RD),
}


def _call_refusal(t, bs):
    return paged_decode_append(t["q"], t["k_new"], t["v_new"], t["k_pool"],
                               t["v_pool"], t["tables"], t["lens"],
                               t["active"], bs, t.get("k_scales"),
                               t.get("v_scales"))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", sorted(CONTRACT_REFUSALS))
def test_contract_refusals_on_both_routes(name, device):
    err, edit, pool_dtype, bs = CONTRACT_REFUSALS[name]
    t = _refusal_args(device, pool_dtype, bs)
    edit(t)
    before = [x.clone() for x in _written(t)] if device == "cpu" else []
    with pytest.raises(err):
        _call_refusal(t, bs)
    for x, y in zip(before, _written(t)):
        assert torch.equal(x, y)          # nothing written


@pytest.mark.parametrize("name", sorted(KERNEL_REFUSALS))
def test_kernel_refusals(name):
    err, edit, pool_dtype, bs = KERNEL_REFUSALS[name]
    t = _refusal_args("meta", pool_dtype, bs)
    edit(t)
    with pytest.raises(err):
        _call_refusal(t, bs)


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.int8])
def test_well_formed_kernel_call_stops_at_the_card_check(pool_dtype):
    """The fused projection's views pass every check of the kernel route
    (at the largest int8 block slice it takes) and reach the device check,
    which a meta tensor fails."""
    bs = MAX_INT8_BLOCK_LEVELS // RD if pool_dtype == torch.int8 else RBS
    t = _refusal_args("meta", pool_dtype, bs)
    with pytest.raises(RuntimeError, match="expected a CUDA tensor"):
        _call_refusal(t, bs)


# ---------------------------------------------------------------------------
# the model's decode step
# ---------------------------------------------------------------------------

CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=1, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_decode_step_calls_the_fused_entry_once_a_layer(monkeypatch,
                                                        kv_dtype):
    """Every decode step of the engine makes one `paged_decode_append`
    call a layer, with the projection's views, and no call of the
    standalone paged attention."""
    calls = []

    def counting(q, *args, **kw):
        calls.append(q.is_contiguous())
        return paged_decode_append(q, *args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the decode step ran the standalone kernel")

    monkeypatch.setattr(t_attention, "paged_decode_append", counting)
    monkeypatch.setattr(pa, "paged_attention", refuse)
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu", seed=0)
    engine = LLMEngine(model, device="cpu", max_batch_size=2, block_size=4,
                       kv_dtype=kv_dtype)
    rng = np.random.default_rng(0)
    for n in (5, 9):
        engine.add_request(rng.integers(0, 128, n).tolist(),
                           max_new_tokens=4)
    engine.run()
    steps = engine.stats()["steps"]
    assert steps > 0
    assert len(calls) == CFG["num_hidden_layers"] * steps
    assert not any(calls)                 # strided views, never copies
