"""The prompt's K/V scatter (`kernels.prefill_scatter`): twin, kernel order
and refusals, on the CPU.

  * the twin (the CPU route of `serving.scatter_prefill` and of
    `prefill_scatter`), with `length` an int or a 0-dim tensor, writes the
    JAX `scatter_prefill`'s pools (fp32: equal; int8: levels and scales
    equal) on every block but null block 0, at lengths before, at and
    after a block boundary and at the bucket's end, with spare blocks past
    the length, a null entry in the row and a previous tenant's bytes and
    scales in the pools;
  * a numpy emulation of the kernel's order of work (one CTA per entry of
    the block row, layer and pool: skip null entries, copy the block's
    real rows, or for int8 a warp's heads read into its lanes' registers
    once, each head's amax folded over the lanes, the scale, 127 / scale
    as one division and the levels from the registers) gives the twin's
    bytes on every block but 0, fp32 and bf16 rows, fp and int8 pools,
    leaves block 0 as it was and reads each value once where a head's
    block fits the registers (twice past them);
  * at head_dim 128 and 32-token blocks the twin's int8 pools and scales
    equal the JAX `quantize_scatter`'s, and the emulation the twin's;
  * the kernel route's refusals, reached with meta tensors (shapes,
    strides and offsets without storage): a well-formed call passes them;
  * CPU tensors never count a launch.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.quantization.kv_cache import quantize_scatter
from paddle_tpu.serving.cache import scatter_prefill as j_scatter

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import prefill_scatter as ps
from paddle_tpu_torch.serving import scatter_prefill

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

LAYERS, T, H, D, BS = 3, 32, 2, 8, 16
# entries 0, 1 hold the prompt's blocks; entry 2 is a spare block past the
# bucket, entry 3 a null entry, entry 4 another spare block
ROW = [5, 2, 7, 0, 3]
NB = 9
LENGTHS = (1, 15, 16, 17, 31, 32)


def _state(dtype, int8, seed):
    """Per-layer K/V rows as strided views of one [T, 3, H, D] projection a
    layer (the forward's layout), and pools that hold a previous tenant's
    bytes (int8: levels and scales)."""
    g = torch.Generator().manual_seed(seed)
    gain = torch.rand((T, 1, 1, 1), generator=g) * 4 + 0.05
    qkv = [(torch.randn((T, 3, H, D), generator=g) * gain).to(dtype)
           for _ in range(LAYERS)]
    shape = (LAYERS, NB, BS, H, D)
    if int8:
        pools = [torch.randint(-127, 128, shape, generator=g,
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand((LAYERS, NB, H), generator=g) * 4 + 0.5
                  for _ in range(2)]
    else:
        pools = [torch.randn(shape, generator=g).to(dtype) for _ in range(2)]
        scales = [None, None]
    return ([x[:, 1] for x in qkv], [x[:, 2] for x in qkv], pools, scales)


def _length(length, kind):
    return torch.tensor(length, dtype=torch.int32) if kind == "tensor" \
        else length


@pytest.mark.parametrize("length_kind", ["int", "tensor"])
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("int8", [False, True])
def test_twin_matches_jax_scatter_prefill(int8, length, length_kind):
    k_rows, v_rows, (kp, vp), (ks, vs) = _state(torch.float32, int8,
                                                 seed=length)
    row = torch.tensor(ROW, dtype=torch.int32)
    stack = [jnp.asarray(torch.stack(rows).numpy())
             for rows in (k_rows, v_rows)]
    scales = (jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy())) if int8 \
        else (None, None)
    want = j_scatter(jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
                     *stack, jnp.asarray(row.numpy()), jnp.int32(length),
                     BS, *scales)
    got = scatter_prefill(kp, vp, k_rows, v_rows, row,
                          _length(length, length_kind), BS, k_scales=ks,
                          v_scales=vs)
    assert got[0] is kp and got[1] is vp            # written in place
    assert len(got) == len(want) == (4 if int8 else 2)
    for g_t, w_t in zip(got, want):
        np.testing.assert_array_equal(g_t.numpy()[:, 1:],
                                      np.asarray(w_t)[:, 1:])


def _raw(t):
    """A tensor's bytes as numpy (bf16 as int16 bits)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _per_lane(bs, d, vec):
    """The kernel's kPV: the fewest 16-byte vectors a lane a head (a power
    of two, at most 16) that hold a full block's head."""
    need = -(-bs * (d // vec) // 32)
    return next(pv for pv in (1, 2, 4, 8, 16) if pv >= need or pv == 16)


def kernel_emulation(k_pools, v_pools, k_rows, v_rows, row, length, bs,
                     k_scales=None, v_scales=None, vec=4, reads=None):
    """The kernel's order of work in numpy, in place: one CTA of 4 warps
    per (entry of the block row, layer, K or V). Rows are ``[L, T, H,
    D]``: raw bytes of the pools' type for fp pools, float32 values for
    int8 pools, whose rows held `vec` values a 16-byte vector. int8: warp
    w takes heads w, w + 4, ..., max(1, 12 // kPV) at a time; vector v of a
    head's block (token v // (D // vec)) is lane v % 32's, and a lane's
    first kPV vectors a head are read into its registers for the whole
    batch before any is used, the rest read again for the levels; the
    head's scale is the lanes' maxima folded, the levels come from the
    registers. `reads`, an array of the rows' shape, counts each value's
    reads."""
    f32 = np.float32
    n_layers, t, h, d = k_rows.shape
    length = min(length, t)
    hv = d // vec
    pv = _per_lane(bs, d, vec)
    hb = max(1, 12 // pv)
    for entry, blk in enumerate(row):
        for layer in range(n_layers):
            for side, (pools, scales, rows) in enumerate(
                    ((k_pools, k_scales, k_rows),
                     (v_pools, v_scales, v_rows))):
                if blk == 0:
                    continue                    # the null block
                first = entry * bs
                n = max(0, min(bs, length - first))
                if scales is None:
                    pools[layer, blk, :n] = rows[layer, first:first + n]
                    continue
                if n == 0:
                    scales[layer, blk] = 0      # a spare block of the row
                    continue

                def at(head, v):
                    tok, c = first + v // hv, v % hv
                    return (layer, tok, head, slice(c * vec, (c + 1) * vec))

                def read(head, v):
                    if reads is not None:
                        reads[side][at(head, v)] += 1
                    return rows[at(head, v)]

                per_head = n * hv
                for warp in range(4):
                    for h0 in range(warp, h, 4 * hb):
                        heads = [x for x in range(h0, h0 + 4 * hb, 4)
                                 if x < h]
                        regs = {(x, v): read(x, v) for x in heads
                                for v in range(min(per_head, 32 * pv))}
                        for x in heads:
                            lane_max = np.zeros(32, f32)
                            for v in range(per_head):
                                vals = regs[x, v] if v < 32 * pv \
                                    else read(x, v)
                                lane_max[v % 32] = max(lane_max[v % 32],
                                                       np.abs(vals).max())
                            sc = max(lane_max.max(), f32(1e-8))
                            scales[layer, blk, x] = sc
                            ratio = f32(127.0) / sc   # one division
                            for v in range(per_head):
                                vals = regs[x, v] if v < 32 * pv \
                                    else read(x, v)
                                tok, c = v // hv, v % hv
                                pools[layer, blk, tok, x,
                                      c * vec:(c + 1) * vec] = np.clip(
                                    np.rint(vals * ratio), -127, 127)


def _emulate_and_compare(k_rows, v_rows, pools, scales, row, length, bs,
                         vec):
    """The emulation against the twin on copies of one state: every block
    but 0 equal, block 0 as it was. Returns the emulation's read counts
    (int8 pools: each value's reads)."""
    int8 = scales[0] is not None
    emu_pools = [_raw(p).copy() for p in pools]
    emu_scales = [None if s is None else s.numpy().copy() for s in scales]
    before = [p.copy() for p in emu_pools]
    rows = [np.stack([_raw((x.float() if int8 else x).contiguous())
                      for x in side]) for side in (k_rows, v_rows)]
    reads = [np.zeros(r.shape, np.int64) for r in rows]
    ps.prefill_scatter_reference(*pools, k_rows, v_rows,
                                 torch.tensor(row, dtype=torch.int32),
                                 torch.tensor(length, dtype=torch.int32), bs,
                                 *scales)
    kernel_emulation(*emu_pools, *rows, row, length, bs, *emu_scales,
                     vec=vec, reads=reads)
    for got, want in zip(emu_pools, pools):
        np.testing.assert_array_equal(got[:, 1:], _raw(want)[:, 1:])
    for got, want in zip(emu_pools, before):
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
    if int8:
        for got, want in zip(emu_scales, scales):
            np.testing.assert_array_equal(got[:, 1:], want.numpy()[:, 1:])
    return reads


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_emulation_matches_twin(dtype, int8, length):
    k_rows, v_rows, pools, scales = _state(dtype, int8, seed=50 + length)
    reads = _emulate_and_compare(k_rows, v_rows, pools, scales, ROW, length,
                                 BS, vec=16 // k_rows[0].element_size())
    if int8:
        # each real token's values read once: the block's heads fit in
        # the lanes' registers
        for r in reads:
            assert np.all(r[:, :length] == 1)
            assert np.all(r[:, length:] == 0)


# int8 pools at head_dim 128 and 32-token blocks: K/V rows of one layer
# [T2, H, D2], a block row of the prompt's two blocks, a spare one and a
# null entry
T2, D2, BS2 = 64, 128, 32
ROW2 = [3, 1, 4, 0]
NB2 = 6
LENGTHS2 = (1, 31, 32, 33, 64)


def _state_wide(dtype, seed):
    g = torch.Generator().manual_seed(seed)
    gain = torch.rand((T2, 1, 1, 1), generator=g) * 4 + 0.05
    qkv = [(torch.randn((T2, 3, H, D2), generator=g) * gain).to(dtype)
           for _ in range(2)]
    shape = (2, NB2, BS2, H, D2)
    pools = [torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.rand((2, NB2, H), generator=g) * 4 + 0.5
              for _ in range(2)]
    return [x[:, 1] for x in qkv], [x[:, 2] for x in qkv], pools, scales


@pytest.mark.parametrize("length", LENGTHS2)
def test_twin_matches_jax_quantize_scatter_wide_heads(length):
    """head_dim 128, 32-token blocks: the twin's int8 pools and scales
    equal the JAX `quantize_scatter`'s, layer by layer, on every block
    but 0."""
    k_rows, v_rows, pools, scales = _state_wide(torch.float32, seed=length)
    row = torch.tensor(ROW2, dtype=torch.int32)
    pidx = np.arange(T2)
    blocks = np.where(pidx < length, np.asarray(ROW2)[pidx // BS2], 0) \
        .astype(np.int32)
    offs = (pidx % BS2).astype(np.int32)
    want = []
    for rows, pool, scale in zip((k_rows, v_rows), pools, scales):
        for layer in range(2):
            want.append(quantize_scatter(
                jnp.asarray(pool[layer].numpy()),
                jnp.asarray(scale[layer].numpy()),
                jnp.asarray(rows[layer].contiguous().numpy()),
                jnp.asarray(blocks), jnp.asarray(offs),
                jnp.asarray(np.asarray(ROW2, np.int32)), jnp.int32(length)))
    ps.prefill_scatter_reference(*pools, k_rows, v_rows, row,
                                 torch.tensor(length, dtype=torch.int32),
                                 BS2, *scales)
    for side, (pool, scale) in enumerate(zip(pools, scales)):
        for layer in range(2):
            w_pool, w_scale = want[2 * side + layer]
            np.testing.assert_array_equal(pool[layer, 1:].numpy(),
                                          np.asarray(w_pool)[1:])
            np.testing.assert_array_equal(scale[layer, 1:].numpy(),
                                          np.asarray(w_scale)[1:])


@pytest.mark.parametrize("length", LENGTHS2)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_emulation_matches_twin_wide_heads(dtype, length):
    """head_dim 128, 32-token blocks, int8 pools: bf16 rows (16 vectors a
    lane a head, all in registers) are read once; fp32 rows (32 vectors a
    lane a head, 16 in registers) read the rest twice."""
    k_rows, v_rows, pools, scales = _state_wide(dtype, seed=70 + length)
    vec = 16 // k_rows[0].element_size()
    assert _per_lane(BS2, D2, vec) == 16
    reads = _emulate_and_compare(k_rows, v_rows, pools, scales, ROW2, length,
                                 BS2, vec)
    in_regs = 32 * 16 * vec // D2              # tokens a head's registers hold
    for r in reads:
        for tok in range(length):
            want = 1 if tok % BS2 < in_regs else 2
            assert np.all(r[:, tok] == want), (tok, np.unique(r[:, tok]))
        assert np.all(r[:, length:] == 0)


def test_cpu_route_counts_no_launch():
    kernels.reset_launch_counts()
    for int8 in (False, True):
        k_rows, v_rows, pools, scales = _state(torch.float32, int8, seed=1)
        out = ps.prefill_scatter(*pools, k_rows, v_rows,
                                 torch.tensor(ROW, dtype=torch.int32), 17, BS,
                                 *scales)
        assert out is None
    counts = kernels.launch_counts()
    assert counts["prefill_scatter"] == counts["prefill_scatter_int8"] == 0


# ---------------------------------------------------------------------------
# the kernel route's refusals, on meta tensors
# ---------------------------------------------------------------------------

def _meta_args(dtype=torch.bfloat16, int8=False, layers=LAYERS, h=H, d=D,
               t=T, device="meta"):
    """A well-formed kernel-route call on `device` (meta: shapes, strides
    and offsets without storage): rows as views of one [T, 3, H, D]
    projection a layer."""
    qkv = [torch.zeros((t, 3, h, d), dtype=dtype, device=device)
           for _ in range(layers)]
    shape = (layers, NB, BS, h, d)
    pool_dtype = torch.int8 if int8 else dtype
    a = dict(k_pools=torch.zeros(shape, dtype=pool_dtype, device=device),
             v_pools=torch.zeros(shape, dtype=pool_dtype, device=device),
             k_layers=[x[:, 1] for x in qkv], v_layers=[x[:, 2] for x in qkv],
             block_row=torch.zeros(len(ROW), dtype=torch.int32,
                                   device=device),
             length=torch.zeros((), dtype=torch.int32, device=device),
             k_scales=None, v_scales=None)
    if int8:
        a["k_scales"], a["v_scales"] = (torch.zeros((layers, NB, h),
                                                    device=device)
                                        for _ in range(2))
    return a


def _check_all(a):
    ps._check(a["k_pools"], a["v_pools"], a["k_layers"], a["v_layers"],
              a["block_row"], BS, a["k_scales"], a["v_scales"])
    ps._check_launch(a["k_pools"], a["v_pools"], a["k_layers"],
                     a["v_layers"], a["block_row"], a["length"],
                     a["k_scales"], a["v_scales"])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_well_formed_kernel_call_passes_the_checks(dtype, int8):
    _check_all(_meta_args(dtype, int8))


def _misaligned(a):
    flat = torch.zeros(T * 3 * H * D + 4, dtype=torch.bfloat16,
                       device="meta")
    rows = flat[4:].view(T, 3, H, D)
    a["k_layers"][0] = rows[:, 1]


def _head_strided(a):
    wide = torch.zeros((T, H, 2 * D), dtype=torch.bfloat16, device="meta")
    a["v_layers"][1] = wide[..., :D]


def _other_row_stride(a):
    a["k_layers"][2] = a["k_layers"][2].contiguous()


def _set(key, value):
    def edit(a):
        a[key] = value(a)
    return edit


REFUSALS = {
    "misaligned rows": (_misaligned, ValueError),
    "rows not contiguous in a head": (_head_strided, ValueError),
    "another row stride": (_other_row_stride, ValueError),
    "fp16 rows": (_set("k_layers", lambda a: [x.half() for x in
                                              a["k_layers"]]), TypeError),
    "pools of another type": (_set("k_pools",
                                   lambda a: a["k_pools"].float()),
                              TypeError),
    "int64 length": (_set("length", lambda a: a["length"].long()),
                     TypeError),
    "int64 block row": (_set("block_row", lambda a: a["block_row"].long()),
                        TypeError),
    "two-element length": (_set("length", lambda a: torch.zeros(
        2, dtype=torch.int32, device="meta")), ValueError),
    "strided block row": (_set("block_row", lambda a: torch.zeros(
        2 * len(ROW), dtype=torch.int32, device="meta")[::2]), ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_kernel_route_refuses(case):
    edit, error = REFUSALS[case]
    a = _meta_args()
    edit(a)
    with pytest.raises(error):
        _check_all(a)


@pytest.mark.parametrize("kw,error", [
    (dict(d=4), ValueError),                    # 8 bytes a head
    (dict(layers=ps.MAX_LAYERS + 1), ValueError),
    (dict(h=ps.MAX_HEADS + 1), ValueError),
])
def test_kernel_route_refuses_geometry(kw, error):
    with pytest.raises(error):
        _check_all(_meta_args(**kw))


@pytest.mark.parametrize("case", ["bucket past the row", "layer count",
                                  "scales with fp pools", "one scale"])
def test_contract_refusals_on_both_routes(case):
    for device in ("cpu", "meta"):
        a = _meta_args(torch.float32, int8=case == "one scale",
                       device=device)
        if case == "bucket past the row":
            a["block_row"] = a["block_row"][:1]
        elif case == "layer count":
            a["k_layers"] = a["k_layers"][:-1]
        elif case == "scales with fp pools":
            a["k_scales"] = a["v_scales"] = torch.zeros(
                (LAYERS, NB, H), device=device)
        else:
            a["v_scales"] = None
        with pytest.raises((ValueError, TypeError)):
            ps.prefill_scatter(a["k_pools"], a["v_pools"], a["k_layers"],
                               a["v_layers"], a["block_row"], a["length"],
                               BS, a["k_scales"], a["v_scales"])
