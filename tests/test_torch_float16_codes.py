"""Every kernel wrapper hands its C entry the type code of its tensors.

Each source in ``paddle_tpu_torch/csrc/`` picks its instantiation by an int
(`kernels._dtype`: 0 float32, 1 bfloat16, 2 float16; the paged decode's
pools 3 for int8), and an instantiation of another type would read the
tensor's bits as that type with no error. These tests drive every wrapper's
kernel route on meta tensors (shapes, strides and a data pointer of 0,
without storage) with the card check, the stream and the library replaced
by recorders, and hold the codes each C entry receives, for each float
type. Nothing launches and no nvcc is needed.
"""
from __future__ import annotations

import contextlib
import types

import pytest
import torch

from paddle_tpu_torch.kernels import (_build, _dtype, adam_update,
                                      cross_entropy, finite_check,
                                      flash_attention, fused_ln, lora_delta,
                                      paged_attention, prefill_scatter)

META = "meta"
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MODULES = (adam_update, cross_entropy, finite_check, flash_attention,
           fused_ln, lora_delta, paged_attention, prefill_scatter)
# what the size queries of the libraries answer
_CONSTANTS = {"paddle_prefill_scatter_max_layers": prefill_scatter.MAX_LAYERS,
              "paddle_prefill_scatter_max_heads": prefill_scatter.MAX_HEADS,
              "paddle_adam_update_chunk": adam_update.CHUNK,
              "paddle_adam_update_max_tensors": adam_update.MAX_TENSORS,
              "paddle_finite_check_chunk": adam_update.CHUNK,
              "paddle_finite_check_max_tensors": adam_update.MAX_TENSORS}


class _Entry:
    """A C entry that records its arguments and returns 0 (success)."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __call__(self, *args):
        if self.name in _CONSTANTS:
            return _CONSTANTS[self.name]
        self.calls.append((self.name, args))
        return 0


class _Library:
    def __init__(self, calls):
        self._calls = calls

    def __getattr__(self, name):
        entry = _Entry(name, self._calls)
        setattr(self, name, entry)
        return entry


@pytest.fixture
def calls(monkeypatch):
    """The C entries' calls, ``[(name, args)]``, with the card check, the
    CUDA stream and device context and the libraries replaced."""
    record = []
    lib = _Library(record)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    for mod in MODULES:
        if hasattr(mod, "require_hopper"):
            monkeypatch.setattr(mod, "require_hopper", lambda t: None)
        if hasattr(mod, "_LIB"):
            monkeypatch.setattr(mod, "_LIB", [])
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return record


def _codes(record, name, *positions):
    """The ints at `positions` (from the end) of the last call of entry
    `name`."""
    args = [a for n, a in record if n == name][-1]
    return tuple(int(getattr(args[p], "value", args[p])) for p in positions)


def _want(dtype):
    return {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[dtype]


def test_the_codes_are_the_sources():
    assert _dtype.CODES == {torch.float32: 0, torch.bfloat16: 1,
                            torch.float16: 2}
    assert _dtype.pool_code(torch.int8) == 3
    assert _dtype.wide_code(torch.float64) == _dtype.FLOAT64 == 4
    assert all(_dtype.wide_code(d) == _dtype.dtype_code(d) for d in DTYPES)
    with pytest.raises(TypeError):
        _dtype.dtype_code(torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_forward_and_backward(calls, dtype):
    q, k, v = (torch.zeros((2, 16, 3, 2, 64), dtype=dtype, device=META)
               .unbind(2))
    out, lse = flash_attention.flash_attention_fwd(q, k, v, True)
    assert _codes(calls, "paddle_flash_attention_fwd", -2) == (_want(dtype),)
    do = torch.zeros_like(out)
    flash_attention.flash_attention_bwd(q, k, v, out, lse, do, True)
    for name in ("dq", "dkv"):
        assert _codes(calls, f"paddle_flash_attention_bwd_{name}", -2) == \
            (_want(dtype),)


def _paged_inputs(q_dtype, pool_dtype, s=2, h=2, d=64, bs=4, m=3):
    qkv = torch.zeros((s, 3, h, d), dtype=q_dtype, device=META)
    pool = torch.zeros((1 + s * m, bs, h, d), dtype=pool_dtype, device=META)
    scales = None
    if pool_dtype == torch.int8:
        scales = torch.zeros((1 + s * m, h), device=META)
    tables = torch.zeros((s, m), dtype=torch.int32, device=META)
    lens = torch.zeros(s, dtype=torch.int32, device=META)
    active = torch.zeros(s, dtype=torch.bool, device=META)
    return qkv, pool, scales, tables, lens, active, bs


@pytest.mark.parametrize("pool_dtype", DTYPES + (torch.int8,))
@pytest.mark.parametrize("q_dtype", DTYPES)
def test_paged_decode_alone_and_fused(calls, q_dtype, pool_dtype):
    qkv, pool, scales, tables, lens, active, bs = _paged_inputs(q_dtype,
                                                                pool_dtype)
    want = (_want(q_dtype), _dtype.pool_code(pool_dtype))
    paged_attention.paged_attention(qkv[:, 0].contiguous(), pool,
                                    pool.clone(), tables, lens, bs, scales,
                                    None if scales is None
                                    else scales.clone())
    assert _codes(calls, "paddle_paged_decode", -3, -2) == want
    paged_attention.paged_decode_append(
        qkv[:, 0], qkv[:, 1], qkv[:, 2], pool, pool.clone(), tables, lens,
        active, bs, scales, None if scales is None else scales.clone())
    assert _codes(calls, "paddle_paged_decode_append", -3, -2) == want


@pytest.mark.parametrize("pool_dtype", DTYPES + (torch.int8,))
@pytest.mark.parametrize("row_dtype", DTYPES)
def test_prefill_scatter(calls, row_dtype, pool_dtype):
    qkv = torch.zeros((8, 3, 2, 64), dtype=row_dtype, device=META)
    layers = [qkv[:, 1]] * 2
    pools = torch.zeros((2, 7, 4, 2, 64), dtype=pool_dtype, device=META)
    scales = None
    if pool_dtype == torch.int8:
        scales = torch.zeros((2, 7, 2), device=META)
    prefill_scatter.prefill_scatter(
        pools, pools.clone(), layers, layers,
        torch.zeros(2, dtype=torch.int32, device=META),
        torch.zeros((), dtype=torch.int32, device=META), 4, scales,
        None if scales is None else scales.clone())
    rows = _want(row_dtype)
    want = rows if pool_dtype in (torch.int8, row_dtype) \
        else 3 + 3 * _want(pool_dtype) + rows
    assert _codes(calls, "paddle_prefill_scatter", -2) == (want,)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_entropy(calls, dtype):
    logits = torch.zeros((4, 8192), dtype=dtype, device=META)
    labels = torch.zeros(4, dtype=torch.int64, device=META)
    loss, lse = cross_entropy.cross_entropy_fwd(logits, labels)
    assert _codes(calls, "paddle_cross_entropy_fwd", -2) == (_want(dtype),)
    cross_entropy.cross_entropy_bwd(logits, labels, lse, loss)
    assert _codes(calls, "paddle_cross_entropy_bwd", -2) == (_want(dtype),)


@pytest.mark.parametrize("affine_dtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_ln(calls, dtype, affine_dtype):
    x = torch.zeros((4, 256), dtype=dtype, device=META)
    affine = [torch.zeros(256, dtype=affine_dtype, device=META)
              for _ in range(3)]
    fused_ln.fused_ln_fwd(x, x.clone(), *affine)
    assert _codes(calls, "paddle_fused_ln", -3, -2) == \
        (_want(dtype), _want(affine_dtype))


@pytest.mark.parametrize("guard", [None, "probe", "apply"])
@pytest.mark.parametrize("masters", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_adam_update(calls, dtype, masters, guard):
    params = [torch.zeros(n, dtype=dtype, device=META) for n in (5, 4096)]
    grads = [torch.zeros_like(p) for p in params]
    fp32 = [[torch.zeros(p.shape, device=META) for p in params]
            for _ in range(3)]
    scalar = torch.zeros(1, device=META)
    flag = None if guard is None else torch.zeros((), dtype=torch.int32,
                                                  device=META)
    adam_update.adam_update(params, grads, fp32[0], fp32[1],
                            fp32[2] if masters else [None] * 2,
                            [True, False], scalar, scalar.clone(), 0.9,
                            0.999, 1e-8, 0.01, guard=guard, flag=flag)
    mode = 0 if guard is None else adam_update.GUARDS[guard]
    assert _codes(calls, "paddle_adam_update", -4, -2) == (mode,
                                                           _want(dtype))
    name = "adam_update" if guard is None else f"adam_update_{guard}"
    assert adam_update.launches[name] > 0


@pytest.mark.parametrize("unscale", [False, True])
def test_multi_tensor_finite(calls, unscale):
    """One launch per dtype of a mixed list, each with its code."""
    tensors = [torch.zeros(n, dtype=dtype, device=META)
               for n in (3, 70000) for dtype in DTYPES]
    flag = torch.zeros((), dtype=torch.int32, device=META)
    scale = torch.zeros((), device=META) if unscale else None
    finite_check.multi_tensor_finite(tensors, flag, scale)
    got = [a for n, a in calls if n == "paddle_multi_tensor_finite"]
    assert [(int(a[0]), int(a[-2])) for a in got] == [
        (2, _want(d)) for d in DTYPES]
    name = "multi_tensor_finite_unscale" if unscale \
        else "multi_tensor_finite"
    assert finite_check.launches[name] >= len(DTYPES)


def test_multi_tensor_copy_if(calls):
    dsts = [torch.zeros(n, dtype=dtype, device=META)
            for n in (3, 70000) for dtype in DTYPES]
    srcs = [torch.zeros_like(t) for t in dsts]
    finite_check.multi_tensor_copy_if(
        dsts, srcs, torch.zeros((), dtype=torch.int32, device=META))
    got = [a for n, a in calls if n == "paddle_multi_tensor_copy_if"]
    assert [(int(a[0]), int(a[-2])) for a in got] == [
        (2, _want(d)) for d in DTYPES]


@pytest.mark.parametrize("unscale", [False, True])
def test_multi_tensor_finite_dense_layouts_and_float64(calls, unscale):
    """A transposed (dense, not contiguous) tensor goes to the kernel by
    the start of its elements, float64 with code 4; a strided slice is
    refused before any launch."""
    grads = [torch.zeros(6, 4, device=META).t(),
             torch.zeros(3, 5, 7, dtype=torch.float64,
                         device=META).permute(2, 0, 1)]
    flag = torch.zeros((), dtype=torch.int32, device=META)
    scale = torch.zeros((), device=META) if unscale else None
    finite_check.multi_tensor_finite(grads, flag, scale)
    got = [a for n, a in calls if n == "paddle_multi_tensor_finite"]
    assert [(int(a[0]), int(a[-2])) for a in got] == [(1, 0),
                                                      (1, _dtype.FLOAT64)]
    assert [a[2][0] for a in got] == [24, 105]
    with pytest.raises(ValueError, match="dense in memory"):
        finite_check.multi_tensor_finite(
            [torch.zeros(6, 8, device=META)[:, ::2]], flag, scale)
    with pytest.raises(TypeError, match="finite-check kernels take"):
        finite_check.multi_tensor_finite(
            [torch.zeros(4, dtype=torch.int32, device=META)], flag, scale)
    assert len([n for n, _ in calls
                if n == "paddle_multi_tensor_finite"]) == 2


def test_multi_tensor_copy_if_dense_layouts(calls):
    """Pairs laid out alike (both transposed, float64 too) go to the
    kernel; a pair laid out apart is refused."""
    flag = torch.zeros((), dtype=torch.int32, device=META)
    dsts = [torch.zeros(6, 4, device=META).t(),
            torch.zeros(5, 3, dtype=torch.float64, device=META).t()]
    srcs = [torch.empty_like(t) for t in dsts]
    assert [s.stride() for s in srcs] == [d.stride() for d in dsts]
    finite_check.multi_tensor_copy_if(dsts, srcs, flag)
    got = [a for n, a in calls if n == "paddle_multi_tensor_copy_if"]
    assert [int(a[-2]) for a in got] == [0, _dtype.FLOAT64]
    with pytest.raises(ValueError, match="laid out alike"):
        finite_check.multi_tensor_copy_if(
            dsts[:1], [torch.zeros(4, 6, device=META)], flag)


@pytest.mark.parametrize("form", lora_delta.FORMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_lora_delta(calls, dtype, form):
    n, d_in, d_out, k, layers, rank = 8, 64, 96, 3, 2, 4
    y = torch.zeros((n, d_out), dtype=dtype, device=META)
    x = torch.zeros((n, d_in), dtype=dtype, device=META)
    a = torch.zeros((k, layers, d_in, rank), dtype=dtype, device=META)
    b = torch.zeros((k, layers, rank, d_out), dtype=dtype, device=META)
    scale = torch.zeros(k, device=META)
    idx = torch.zeros(n, dtype=torch.int32, device=META)
    if form == "tile":
        idx = torch.zeros(1, dtype=torch.int32, device=META).expand(n)
    lora_delta.lora_delta(y, x, a, b, scale, idx, 1)
    assert _codes(calls, "paddle_lora_delta", -3, -2) == \
        (lora_delta.FORMS.index(form), _want(dtype))
