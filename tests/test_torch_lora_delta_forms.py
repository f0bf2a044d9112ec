"""The adapter delta's two kernel forms, as far as the CPU can hold them.

`lora_delta` launches one of two forms of its kernel, picked by
`lora_form` from the slot index's stride alone (never from its values, so
a captured graph stays right whatever slots it later reads): the row form
for a slot a row (decode), the tile form for one slot expanded over the
rows with stride 0 (prefill). These tests hold, on the CPU:

  * the form choice as a pure function, on the engine's own slot and
    prefill buffers (meta tensors) expanded as the projection hook
    expands them: a decode batch, a one-slot decode batch (its one row
    keeps stride 1, so the row form, and the twin stays right there), a
    prefill bucket;
  * the kernel route's refusals for what the forms do not take (ranks past
    their shared memory) and its acceptance of what they do (ranks that
    are not a multiple of the 16-byte vector, a long x row in the tile
    form, unaligned views): a well-formed call fails only for want of a
    card;
  * the twin against the reference's `_adapter_forward` at ranks 4, 8, 12
    and 16, fp32 and bf16, in the decode and prefill forms, within
    `lora_delta_tol`, base rows bit for bit;
  * `lora_delta_exact` (the twin's arithmetic with fp64 sums, the card
    check's second yardstick): equal to the twin where every sum is
    exact, within the bound of it otherwise.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.serving.tenancy import AdapterSet as JAdapterSet
from paddle_tpu.serving.tenancy import _adapter_forward

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import lora_delta as ld
from paddle_tpu_torch.serving.engine import (_prefill_buffer, _prefill_views,
                                             _slot_buffer, _slot_views)

K, L = 3, 2
HIDDEN = 48


def _hook_idx(idx, rows):
    """The slot index as the projection hook hands it to the kernel
    (`serving/tenancy.py` `_hook`)."""
    return idx.expand(rows) if idx.numel() == 1 else idx


# ---------------------------------------------------------------------------
# the form choice
# ---------------------------------------------------------------------------

def _decode_idx(slots):
    buf = _slot_buffer(slots, 4, "meta")
    return _slot_views(buf, slots, 4)[10]


def _prefill_idx():
    buf = _prefill_buffer(64, 4, "meta")
    return _prefill_views(buf, 64, 4)[9]


FORM_CASES = {
    "decode batch of 8": (lambda: _hook_idx(_decode_idx(8), 8), "row"),
    "one-slot decode batch": (lambda: _hook_idx(_decode_idx(1), 1), "row"),
    "prefill bucket of 16": (lambda: _hook_idx(_prefill_idx(), 16), "tile"),
    "prefill bucket of 1024": (lambda: _hook_idx(_prefill_idx(), 1024),
                               "tile"),
    "stride 0": (lambda: torch.empty(1, dtype=torch.int32,
                                     device="meta").expand(5), "tile"),
    "stride 1": (lambda: torch.empty(5, dtype=torch.int32, device="meta"),
                 "row"),
    "strided slots": (lambda: torch.empty(10, dtype=torch.int32,
                                          device="meta")[::2], "row"),
}


@pytest.mark.parametrize("name", sorted(FORM_CASES))
def test_form_follows_the_index_stride(name):
    make, want = FORM_CASES[name]
    idx = make()
    assert idx.device.type == "meta"
    assert ld.lora_form(idx) == want


def test_form_ignores_the_slots_values():
    # the same view filled with other slots keeps its form: a captured
    # graph reads new slots through the same launch
    buf = torch.zeros(8, dtype=torch.int32)
    for fill in (0, 1, 2):
        buf.fill_(fill)
        assert ld.lora_form(buf) == "row"
        assert ld.lora_form(buf[:1].expand(8)) == "tile"


# ---------------------------------------------------------------------------
# the kernel route: what the forms refuse and what they take
# ---------------------------------------------------------------------------

def _meta(n=8, d_in=768, d_out=2304, rank=16, dtype=torch.bfloat16,
          stride0=False):
    dev = "meta"
    idx = torch.empty(1, dtype=torch.int32, device=dev).expand(n) \
        if stride0 else torch.empty(n, dtype=torch.int32, device=dev)
    return dict(y=torch.empty((n, d_out), dtype=dtype, device=dev),
                x=torch.empty((n, d_in), dtype=dtype, device=dev),
                a=torch.empty((K, 12, d_in, rank), dtype=dtype, device=dev),
                b=torch.empty((K, 12, rank, d_out), dtype=dtype, device=dev),
                scale=torch.empty(K, dtype=torch.float32, device=dev),
                idx=idx, layer=3)


def _row_limit(d_in):
    """The largest rank the row form takes at this x row."""
    return (ld.SMEM_LIMIT // 4 - d_in) // 9


def _tile_limit():
    """The largest rank (a multiple of 16) the tile form takes."""
    return (ld.SMEM_LIMIT - 8 * 8 * 16 * 16) // (4 * 16) // 16 * 16


REFUSED = {
    "row form, rank past shared memory": dict(rank=_row_limit(768) + 1),
    "tile form, rank past shared memory": dict(rank=_tile_limit() + 1,
                                               n=64, stride0=True),
    "tile form, rank past shared memory, fp32": dict(
        rank=_tile_limit() + 1, n=64, stride0=True, dtype=torch.float32),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_kernel_route_refuses_past_the_forms_shared_memory(name):
    args = _meta(**REFUSED[name])
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="shared"):
        ld.lora_delta(**args)
    assert kernels.launch_counts()["lora_delta"] == 0


def _misaligned(args):
    # y, x and A one element into their storage: no 16-byte vectors
    for key in ("y", "x"):
        t = args[key]
        args[key] = torch.empty((t.shape[0], t.shape[1] + 1), dtype=t.dtype,
                                device="meta")[:, 1:]
    a = args["a"]
    args["a"] = torch.empty(a.numel() + 1, dtype=a.dtype,
                            device="meta")[1:].view(a.shape)
    return args


TAKEN = {
    "row form, rank 4": dict(rank=4),
    "row form, rank 12": dict(rank=12),
    "row form, rank 3, odd widths": dict(rank=3, d_in=50, d_out=150),
    "row form, rank at its limit": dict(rank=_row_limit(768)),
    "tile form, rank 4": dict(rank=4, n=1024, stride0=True),
    "tile form, rank 12": dict(rank=12, n=37, stride0=True),
    "tile form, rank 40": dict(rank=40, n=37, stride0=True),
    "tile form, rank at its limit": dict(rank=_tile_limit(), n=16,
                                         stride0=True),
    "tile form, x row past the row form's shared memory": dict(
        d_in=12288, d_out=768, n=64, stride0=True),
    "tile form, fp32": dict(n=1024, stride0=True, dtype=torch.float32),
    "row form, fp32, rank 4": dict(rank=4, dtype=torch.float32),
}


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("name", sorted(TAKEN))
def test_kernel_route_takes_what_the_forms_take(name, misaligned):
    args = _meta(**TAKEN[name])
    if misaligned:
        args = _misaligned(args)
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        ld.lora_delta(**args)
    assert kernels.launch_counts()["lora_delta"] == 0


def test_shared_memory_of_the_forms():
    # the row form holds the x row, eight warps' sums of x @ A and t; the
    # tile form none of x
    assert ld.smem_bytes("row", 768, 16) == 4 * (768 + 9 * 16)
    assert ld.smem_bytes("tile", 768, 16) == ld.smem_bytes("tile", 12288, 16)
    assert ld.smem_bytes("tile", 768, 4) == ld.smem_bytes("tile", 768, 16)
    assert ld.smem_bytes("tile", 768, 17) > ld.smem_bytes("tile", 768, 16)
    for form, limit in (("row", _row_limit(768)), ("tile", _tile_limit())):
        assert ld.smem_bytes(form, 768, limit) <= ld.SMEM_LIMIT
        assert ld.smem_bytes(form, 768, limit + 1) > ld.SMEM_LIMIT


# ---------------------------------------------------------------------------
# the twin against the reference's arithmetic, by rank
# ---------------------------------------------------------------------------

def _factors(rng, d_in, d_out, rank):
    a = rng.normal(0, 0.3, (K, L, d_in, rank)).astype(np.float32)
    b = rng.normal(0, 0.3, (K, L, rank, d_out)).astype(np.float32)
    a[0] = b[0] = 0
    scale = np.array([0.0, 2.0, 0.75], np.float32)
    return a, b, scale


def _jax_delta(x, w, bias, a, b, scale, layer, slots=None, slot=None,
               dtype="fp32"):
    """The reference's qkv projection without and with its delta."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32

    def t(v):
        return jnp.asarray(v).astype(jdt)

    lin = types.SimpleNamespace(weight=paddle.Tensor(t(w)),
                                bias=paddle.Tensor(t(bias)))
    zeros = (jnp.zeros((K, L, 1, 1), jdt),) * 2
    holder = {"active": None}
    fwd = _adapter_forward(lin, layer, "qkv", holder)
    plain = np.asarray(fwd(paddle.Tensor(t(x)))._value.astype(jnp.float32))
    holder["active"] = JAdapterSet.trace_ctx(
        (t(a), t(b)) + zeros + (jnp.asarray(scale),),
        slots=None if slots is None else jnp.asarray(slots, jnp.int32),
        slot=None if slot is None else jnp.asarray(slot, jnp.int32))
    armed = np.asarray(fwd(paddle.Tensor(t(x)))._value.astype(jnp.float32))
    return plain, armed


REF_FORMS = {"decode": dict(shape=(5, 1), slots=[2, 0, 1, 2, 1]),
             "one-slot decode": dict(shape=(1, 1), slots=[2]),
             "prefill": dict(shape=(1, 7), slot=1)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("rank", [4, 8, 12, 16])
@pytest.mark.parametrize("form", sorted(REF_FORMS))
def test_twin_matches_the_reference_by_rank(form, rank, dtype):
    f = REF_FORMS[form]
    rng = np.random.default_rng(1000 + 10 * rank + len(form) + len(dtype))
    d_out, layer = 3 * HIDDEN, 1
    x = rng.normal(0, 1, f["shape"] + (HIDDEN,)).astype(np.float32)
    w = rng.normal(0, 0.2, (HIDDEN, d_out)).astype(np.float32)
    bias = rng.normal(0, 0.1, d_out).astype(np.float32)
    a, b, scale = _factors(rng, HIDDEN, d_out, rank)
    plain, want = _jax_delta(x, w, bias, a, b, scale, layer,
                             slots=f.get("slots"), slot=f.get("slot"),
                             dtype=dtype)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    n = int(np.prod(f["shape"]))
    rows = torch.tensor(x.reshape(n, HIDDEN)).to(tdt)
    y = torch.tensor(plain.reshape(n, d_out)).to(tdt)
    y0 = y.clone()
    idx = _hook_idx(torch.tensor(f["slots"] if "slots" in f else [f["slot"]],
                                 dtype=torch.int32), n)
    assert ld.lora_form(idx) == ("tile" if form == "prefill" else "row")
    args = (rows, torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt),
            torch.from_numpy(scale), idx, layer)
    tol = ld.lora_delta_tol(y0, *args)
    assert ld.lora_delta(y, *args) is y
    diff = (y.float() - torch.tensor(want.reshape(n, d_out))).abs()
    assert bool((diff <= tol).all()), float((diff - tol).max())
    base = idx == 0
    bits = torch.int16 if dtype == "bf16" else torch.int32
    assert torch.equal(y[base].view(bits), y0[base].view(bits))
    assert float((y.float() - y0.float())[~base].abs().max()) > 0.01


# ---------------------------------------------------------------------------
# lora_delta_exact
# ---------------------------------------------------------------------------

def _state(dtype, n, d_in, d_out, rank, seed, integers=False):
    g = torch.Generator().manual_seed(seed)
    if integers:
        # small integers: every product and sum is exact in fp32 and bf16
        def draw(*shape):
            return torch.randint(-3, 4, shape, generator=g).float()
        x, y = draw(n, d_in), draw(n, d_out)
        a, b = draw(K, L, d_in, rank), draw(K, L, rank, d_out)
        scale = torch.tensor([0.0, 1.0, 2.0])
    else:
        x = torch.randn(n, d_in, generator=g)
        y = torch.randn(n, d_out, generator=g) * 0.5
        a = torch.randn(K, L, d_in, rank, generator=g) * 0.05
        b = torch.randn(K, L, rank, d_out, generator=g) * 0.05
        scale = torch.tensor([0.0, 1.0, 0.5])
    a[0] = 0
    b[0] = 0
    return (y.to(dtype), x.to(dtype), a.to(dtype), b.to(dtype), scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["row", "tile"])
def test_exact_is_the_twin_where_every_sum_is_exact(form, dtype):
    y, x, a, b, scale = _state(dtype, 6, 32, 40, 4, seed=7, integers=True)
    idx = torch.tensor([1, 0, 2, 1, 2, 0], dtype=torch.int32) \
        if form == "row" else torch.tensor([2], dtype=torch.int32).expand(6)
    args = (x, a, b, scale, idx, 1)
    exact = ld.lora_delta_exact(y, *args)
    twin = ld.lora_delta_reference(y.clone(), *args)
    assert exact.dtype == dtype and torch.equal(exact, twin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rank", [4, 16])
@pytest.mark.parametrize("form", ["row", "tile"])
def test_exact_is_within_the_bound_of_the_twin(form, rank, dtype):
    n = 8 if form == "row" else 37
    y, x, a, b, scale = _state(dtype, n, 96, 80, rank, seed=rank + n)
    idx = torch.tensor([0, 1, 2, 1, 0, 2, 2, 1], dtype=torch.int32) \
        if form == "row" else torch.tensor([1], dtype=torch.int32).expand(n)
    args = (x, a, b, scale, idx, 0)
    y0 = y.clone()
    exact = ld.lora_delta_exact(y, *args)
    assert torch.equal(y, y0)                       # y is only read
    twin = ld.lora_delta_reference(y.clone(), *args)
    tol = ld.lora_delta_tol(y0, *args)
    assert bool(((exact.float() - twin.float()).abs() <= tol).all())
    base = idx == 0
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(exact[base].view(bits), y0[base].view(bits))
