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
    real rows, or for int8 the per-head amax, the scale, 127 / scale as
    one division and the levels) gives the twin's bytes on every block
    but 0, fp32 and bf16 rows, fp and int8 pools, and leaves block 0 as
    it was;
  * the kernel route's refusals, reached with meta tensors (shapes,
    strides and offsets without storage): a well-formed call passes them;
  * CPU tensors never count a launch.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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


def kernel_emulation(k_pools, v_pools, k_rows, v_rows, row, length, bs,
                     k_scales=None, v_scales=None):
    """The kernel's order of work in numpy, in place: one CTA per (entry of
    the block row, layer, K or V). Rows are ``[L, T, H, D]``: raw bytes of
    the pools' type for fp pools, float32 values for int8 pools."""
    f32 = np.float32
    n_layers, t = k_rows.shape[:2]
    length = min(length, t)
    for entry, blk in enumerate(row):
        for layer in range(n_layers):
            for pools, scales, rows in ((k_pools, k_scales, k_rows),
                                        (v_pools, v_scales, v_rows)):
                if blk == 0:
                    continue                    # the null block
                first = entry * bs
                n = max(0, min(bs, length - first))
                vals = rows[layer, first:first + n]
                if scales is None:
                    pools[layer, blk, :n] = vals
                    continue
                if n == 0:
                    scales[layer, blk] = 0      # a spare block of the row
                    continue
                sc = np.maximum(np.abs(vals).max(axis=(0, 2)), f32(1e-8))
                scales[layer, blk] = sc
                ratio = f32(127.0) / sc          # one division a head
                pools[layer, blk, :n] = np.clip(
                    np.rint(vals * ratio[None, :, None]), -127, 127) \
                    .astype(np.int8)


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_emulation_matches_twin(dtype, int8, length):
    k_rows, v_rows, pools, scales = _state(dtype, int8, seed=50 + length)
    row = torch.tensor(ROW, dtype=torch.int32)
    emu_pools = [_raw(p).copy() for p in pools]
    emu_scales = [None if s is None else s.numpy().copy() for s in scales]
    before = [p.copy() for p in emu_pools]
    rows = [np.stack([_raw((x.float() if int8 else x).contiguous())
                      for x in side]) for side in (k_rows, v_rows)]
    ps.prefill_scatter_reference(*pools, k_rows, v_rows, row,
                                 torch.tensor(length, dtype=torch.int32), BS,
                                 *scales)
    kernel_emulation(*emu_pools, *rows, ROW, length, BS, *emu_scales)
    for got, want in zip(emu_pools, pools):
        np.testing.assert_array_equal(got[:, 1:], _raw(want)[:, 1:])
    for got, want in zip(emu_pools, before):
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
    if int8:
        for got, want in zip(emu_scales, scales):
            np.testing.assert_array_equal(got[:, 1:], want.numpy()[:, 1:])


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
