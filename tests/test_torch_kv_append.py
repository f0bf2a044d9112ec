"""Port parity: the decode step's KV append, the write half of the fused
paged decode kernel (`kernels.paged_attention.paged_decode_append`),
whose plain version is `kernels.kv_append.kv_append_reference`.

  * the fused entry's CPU route (`fused_write`: `paged_decode_append`
    called for its write, which the twin makes) against the JAX package's
    decode write on the same numpy inputs, bit for bit on every block but
    null block 0: `paged_decode_attention`'s fp ``.at[write_block,
    write_off].set`` (fp32 and bf16 pools) and its int8 leg,
    `quantize_block_write` (levels AND scales);
  * `kernel_emulation`, a loop per (slot, pool, head) in the CUDA
    kernel's order of operations with inactive slots skipped (the kernel
    writes nothing for them), against the batched twin, bit for bit on
    every block but 0, with block 0 left as it was: the arithmetic the
    card's `chip_smoke.py` check then holds the kernel to;
  * the contract's refusals (dtype, shape, contiguity), shared by the
    fused entry and the twin, and strided new rows read as they are.

Block 0 is left out of every comparison: the twin writes inactive slots'
vectors there (duplicate targets, as the reference), the kernel skips
them, and nothing ever reads block 0 unmasked.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.nn.functional.attention import \
    paged_decode_attention as j_paged

from paddle_tpu_torch.kernels.kv_append import kv_append_reference
from paddle_tpu_torch.kernels.paged_attention import paged_decode_append

S, H, D, BS, M = 4, 2, 64, 16, 7
NB = 1 + S * M

# (lens, active) per case: write offsets 0, 1, 15 and mid-block (8), a new
# block at a boundary, an inactive slot with a live table row and one
# with a cleared row
CASES = {
    "offsets_0_1_15_mid": ([0, 1, 15, 8], [True, True, True, True]),
    "boundary_and_last": ([16, 31, 111, 47], [True, True, True, True]),
    "inactive_live_row": ([24, 9, 40, 100], [True, False, True, True]),
    "inactive_cleared_row": ([2, 0, 17, 63], [True, True, False, True]),
}
KINDS = ("float32", "bfloat16", "int8_f32_rows", "int8_bf16_rows")


def _state(case, kind, seed=0):
    """Numpy inputs: new rows [S, H, D] (scaled per slot, so some int8
    blocks' scales grow and some shrink), pools holding a previous
    tenant's data (int8: random levels under scales mostly larger than the
    new rows), dense-prefix tables over disjoint blocks."""
    lens, active = CASES[case]
    rng = np.random.default_rng(seed)
    gain = np.asarray([0.01, 3.0, 0.5, 10.0], np.float32)[:, None, None]
    k_new, v_new = ((rng.standard_normal((S, H, D)) * gain)
                    .astype(np.float32) for _ in range(2))
    tables = np.stack([1 + s * M + np.arange(M) for s in range(S)]) \
        .astype(np.int32)
    active = np.asarray(active, bool)
    if case == "inactive_cleared_row":
        tables[~active] = 0
    st = dict(k_new=k_new, v_new=v_new, tables=tables,
              lens=np.asarray(lens, np.int32), active=active)
    if kind.startswith("int8"):
        st["k_pool"], st["v_pool"] = (
            rng.integers(-127, 128, (NB, BS, H, D)).astype(np.int8)
            for _ in range(2))
        st["k_scales"], st["v_scales"] = (
            rng.uniform(0.05, 4.0, (NB, H)).astype(np.float32)
            for _ in range(2))
    else:
        st["k_pool"], st["v_pool"] = (
            rng.standard_normal((NB, BS, H, D)).astype(np.float32)
            for _ in range(2))
    return st


def _rows_dtype(kind):
    return torch.bfloat16 if "bf16" in kind or kind == "bfloat16" \
        else torch.float32


def _torch_args(st, kind):
    """The state as torch tensors: new rows (and fp pools) in the kind's
    type, copies of the pools and scales (written in place)."""
    rows = _rows_dtype(kind)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).clone()
         for k, v in st.items()}
    for k in ("k_new", "v_new"):
        t[k] = t[k].to(rows)
    if not kind.startswith("int8"):
        for k in ("k_pool", "v_pool"):
            t[k] = t[k].to(rows)
    return t


def _call(fn, t):
    fn(t["k_new"], t["v_new"], t["k_pool"], t["v_pool"], t["tables"],
       t["lens"], t["active"], BS, t.get("k_scales"), t.get("v_scales"))


def fused_write(k_new, v_new, k_pool, v_pool, tables, lens, active, bs,
                k_scales=None, v_scales=None):
    """`paged_decode_append` called for its write: q a zero tensor of the
    rows' type, shape and strides; its output is not read."""
    paged_decode_append(torch.zeros_like(k_new), k_new, v_new, k_pool,
                        v_pool, tables, lens, active, bs, k_scales, v_scales)


def _outputs(t):
    keys = ("k_pool", "v_pool", "k_scales", "v_scales")
    return [t[k].float().numpy() for k in keys if k in t]


def _jax_write(st, kind):
    """The JAX decode step's write on the same inputs: its returned pools
    (and scales) from `paged_decode_attention` (dense reference attention,
    whose output is not compared here)."""
    rows = jnp.bfloat16 if _rows_dtype(kind) == torch.bfloat16 \
        else jnp.float32
    k_new, v_new = (jnp.asarray(st[k]).astype(rows)[:, None]
                    for k in ("k_new", "v_new"))
    q = jnp.zeros((S, 1, H, D), rows)
    if kind.startswith("int8"):
        pools = (jnp.asarray(st["k_pool"]), jnp.asarray(st["v_pool"]))
        scales = dict(k_scales=jnp.asarray(st["k_scales"]),
                      v_scales=jnp.asarray(st["v_scales"]))
    else:
        pools = (jnp.asarray(st["k_pool"]).astype(rows),
                 jnp.asarray(st["v_pool"]).astype(rows))
        scales = {}
    out = j_paged(q, k_new, v_new, *pools, jnp.asarray(st["tables"]),
                  jnp.asarray(st["lens"]), jnp.asarray(st["active"]), BS,
                  kernel="reference", **scales)
    return [np.asarray(a).astype(np.float32) for a in out[1:]]


def kernel_emulation(k_new, v_new, k_pool, v_pool, tables, lens, active,
                     bs, k_scales=None, v_scales=None):
    """The fused CUDA kernel's write arithmetic in numpy fp32, one (slot,
    pool, head) at a time, in place: inactive slots write nothing; fp pools take the
    row as it is; an int8 block is dequantized as ``level * (scale * c)``
    (c = fp32 1/127), the new row inserted at the offset, later offsets
    zeroed, ``new_sc = max(max |x|, fp32 1e-8)``, ``r = 127 / new_sc``
    (one division) and the levels ``clip(rint(x * r), -127, 127)``."""
    f32 = np.float32
    c, eps = f32(1.0 / 127.0), f32(1e-8)
    for s in range(len(lens)):
        if not active[s]:
            continue
        blk, off = tables[s, lens[s] // bs], lens[s] % bs
        for pool, scales, new in ((k_pool, k_scales, k_new),
                                  (v_pool, v_scales, v_new)):
            if scales is None:
                pool[blk, off] = new[s]
                continue
            for h in range(new.shape[1]):
                deq = f32(scales[blk, h]) * c
                x = np.zeros((bs, new.shape[2]), np.float32)
                x[:off] = pool[blk, :off, h].astype(np.float32) * deq
                x[off] = new[s, h]
                new_sc = max(np.abs(x).max(), eps)
                r = f32(127.0) / new_sc
                pool[blk, :, h] = np.clip(np.rint(x * r), -127, 127) \
                    .astype(np.int8)
                scales[blk, h] = new_sc


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_route_matches_jax_write(case, kind):
    st = _state(case, kind, seed=len(case))
    t = _torch_args(st, kind)
    pools = [t[k] for k in ("k_pool", "v_pool")]
    _call(fused_write, t)
    assert t["k_pool"] is pools[0] and t["v_pool"] is pools[1]
    for got, want in zip(_outputs(t), _jax_write(st, kind)):
        np.testing.assert_array_equal(got[1:], want[1:])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_emulation_matches_twin(case, kind):
    st = _state(case, kind, seed=7 + len(case))
    t = _torch_args(st, kind)
    _call(kv_append_reference, t)
    emu = {k: v.float().numpy().copy() if k in ("k_new", "v_new")
           or v.dtype == torch.bfloat16 else v.numpy().copy()
           for k, v in _torch_args(st, kind).items()}
    before = {k: v.copy() for k, v in emu.items()}
    kernel_emulation(emu["k_new"], emu["v_new"], emu["k_pool"],
                     emu["v_pool"], emu["tables"], emu["lens"],
                     emu["active"], BS, emu.get("k_scales"),
                     emu.get("v_scales"))
    keys = [k for k in ("k_pool", "v_pool", "k_scales", "v_scales")
            if k in emu]
    for k, got in zip(keys, _outputs(t)):
        np.testing.assert_array_equal(emu[k][1:].astype(np.float32),
                                      got[1:])
        # the kernel leaves block 0 alone
        np.testing.assert_array_equal(emu[k][0], before[k][0])


def test_int8_scale_shrinks_and_grows_and_stale_offsets_zeroed():
    """A reused block: offsets past the write position held a previous
    tenant's levels; after the append they are 0, and the scale follows
    the block's live values (down for a small row at offset 0, up for a
    large one)."""
    st = _state("offsets_0_1_15_mid", "int8_f32_rows", seed=3)
    t = _torch_args(st, "int8_f32_rows")
    _call(fused_write, t)
    tables, lens = st["tables"], st["lens"]
    for s, off in enumerate(lens % BS):
        blk = tables[s, lens[s] // BS]
        assert not t["k_pool"][blk, off + 1:].any()
    blk0 = tables[0, 0]
    assert (t["k_scales"][blk0] < torch.from_numpy(st["k_scales"][blk0])).all()
    blk3 = tables[3, 0]
    assert (t["k_scales"][blk3] > torch.from_numpy(st["k_scales"][blk3])).all()


@pytest.mark.parametrize("kind", ["bfloat16", "int8_bf16_rows"])
def test_strided_rows_read_as_they_are(kind):
    """k_new / v_new as the strided views of one fused [S, 3, H, D]
    projection write what their contiguous copies write."""
    st = _state("offsets_0_1_15_mid", kind, seed=5)
    a, b = _torch_args(st, kind), _torch_args(st, kind)
    qkv = torch.stack([torch.zeros_like(b["k_new"]), b["k_new"],
                       b["v_new"]], dim=1)
    b["k_new"], b["v_new"] = qkv[:, 1], qkv[:, 2]
    assert not b["k_new"].is_contiguous()
    _call(fused_write, a)
    _call(fused_write, b)
    for x, y in zip(_outputs(a), _outputs(b)):
        np.testing.assert_array_equal(x, y)


def _refusal_args(kind="float32"):
    return _torch_args(_state("offsets_0_1_15_mid", kind), kind)


REFUSALS = {
    # dtype
    "rows_of_another_type": (TypeError, lambda t: t.update(
        k_new=t["k_new"].double(), v_new=t["v_new"].double())),
    "int64_tables": (TypeError, lambda t: t.update(tables=t["tables"].long())),
    "int64_lens": (TypeError, lambda t: t.update(lens=t["lens"].long())),
    "int_active": (TypeError, lambda t: t.update(active=t["active"].int())),
    "scales_with_fp_pools": (TypeError, lambda t: t.update(
        k_scales=torch.ones(NB, H), v_scales=torch.ones(NB, H))),
    # shape
    "rows_4d": (ValueError, lambda t: t.update(k_new=t["k_new"][:, None],
                                                v_new=t["v_new"][:, None])),
    "pool_block_size": (ValueError, lambda t: t.update(
        k_pool=t["k_pool"][:, :8].contiguous(),
        v_pool=t["v_pool"][:, :8].contiguous())),
    "tables_rows": (ValueError, lambda t: t.update(tables=t["tables"][:2])),
    "lens_length": (ValueError, lambda t: t.update(lens=t["lens"][:3])),
    "one_scale": (ValueError, lambda t: t.update(k_scales=torch.ones(NB, H))),
    # contiguity
    "strided_pool": (ValueError, lambda t: t.update(
        k_pool=t["k_pool"].transpose(2, 3).contiguous().transpose(2, 3))),
    "strided_tables": (ValueError, lambda t: t.update(
        tables=t["tables"].t().contiguous().t())),
}
INT8_REFUSALS = {
    "float64_scales": (TypeError, lambda t: t.update(
        k_scales=t["k_scales"].double(), v_scales=t["v_scales"].double())),
    "scales_shape": (ValueError, lambda t: t.update(
        k_scales=t["k_scales"][:, :1].contiguous(),
        v_scales=t["v_scales"][:, :1].contiguous())),
    "int_rows": (TypeError, lambda t: t.update(
        k_new=t["k_new"].int(), v_new=t["v_new"].int())),
    "strided_scales": (ValueError, lambda t: t.update(
        k_scales=t["k_scales"].t().contiguous().t())),
}


@pytest.mark.parametrize("fn", [fused_write, kv_append_reference],
                         ids=["wrapper", "twin"])
@pytest.mark.parametrize("name", sorted(REFUSALS) + sorted(INT8_REFUSALS))
def test_refusals(name, fn):
    err, edit = REFUSALS.get(name) or INT8_REFUSALS[name]
    t = _refusal_args("int8_f32_rows" if name in INT8_REFUSALS
                      else "float32")
    edit(t)
    before = [x.clone() for x in _outputs_t(t)]
    with pytest.raises(err):
        _call(fn, t)
    for x, y in zip(before, _outputs_t(t)):
        assert torch.equal(x, y)          # nothing written


def _outputs_t(t):
    return [t[k] for k in ("k_pool", "v_pool", "k_scales", "v_scales")
            if t.get(k) is not None]
