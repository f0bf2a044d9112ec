"""The batched adapter delta's plain twin against the reference's
arithmetic, and the kernel route's refusals.

The reference has no Pallas kernel here: its delta is XLA einsums inside
`paddle_tpu/serving/tenancy.py` `_adapter_forward` (decode: each batch
slot gathers its adapter's factors; prefill: one scalar slot for every
row). These tests run that function on a projection's inputs and feed the
same projection output to `lora_delta_reference`, so only the delta's
arithmetic is compared:

  * decode form (``[S, 1, in]``, a slot index a row, base rows among
    them) and prefill form (``[1, n, in]``, one slot), the qkv and out
    widths, fp32 and bf16: within `lora_delta_tol` (the bound derived in
    its docstring from the roundings both computations make);
  * the bound's repair: at a 1024-row prefill of rank 4 where the twin's
    fp32 x @ A sums cross a rounding step that fp64 sums do not (elements
    the earlier rule of one 2^-8 (bf16) / 2^-20 (fp32) rounding per
    step missed), fp64 sums stay within the bound of the twin; and the bound
    still sees a wrong delta: the twin's delta with one rank column
    dropped, or its scale times (1 + 2^-5), leaves it at the decode and
    the prefill shapes;
  * rows of slot 0 are bit for bit the projection's output, -0.0
    included, whatever the other rows do;
  * on CPU tensors `lora_delta` is the twin and launches nothing; on other
    devices the kernel route checks its inputs before it loads a library:
    its refusals are reached with meta tensors (shapes and strides without
    storage), and a well-formed call fails only for want of a CUDA card.
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

K, L, R = 3, 2, 4
HIDDEN = 48


def _factors(rng, d_in, d_out):
    """A [K, L, in, r] and B [K, L, r, out] with slot 0 zero, scale [K]."""
    a = rng.normal(0, 0.3, (K, L, d_in, R)).astype(np.float32)
    b = rng.normal(0, 0.3, (K, L, R, d_out)).astype(np.float32)
    a[0] = b[0] = 0
    scale = np.array([0.0, 2.0, 0.75], np.float32)
    return a, b, scale


def _jax_delta(x, w, bias, a, b, scale, tname, layer, slots=None, slot=None,
               dtype=np.float32):
    """The reference's projection with its adapter delta, and without."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32

    def t(v):
        return jnp.asarray(v).astype(jdt)

    lin = types.SimpleNamespace(weight=paddle.Tensor(t(w)),
                                bias=paddle.Tensor(t(bias)))
    zeros = [jnp.zeros((K, L, 1, 1), jdt)] * 2
    stacks = ((t(a), t(b)) + tuple(zeros)) if tname == "qkv" else \
        (tuple(zeros) + (t(a), t(b)))
    holder = {"active": None}
    fwd = _adapter_forward(lin, layer, tname, holder)
    plain = np.asarray(fwd(paddle.Tensor(t(x)))._value.astype(jnp.float32))
    holder["active"] = JAdapterSet.trace_ctx(
        stacks + (jnp.asarray(scale),),
        slots=None if slots is None else jnp.asarray(slots, jnp.int32),
        slot=None if slot is None else jnp.asarray(slot, jnp.int32))
    armed = np.asarray(fwd(paddle.Tensor(t(x)))._value.astype(jnp.float32))
    return plain, armed


def _torch(v, dtype):
    return torch.from_numpy(np.array(v)).to(dtype)


FORMS = {"decode": dict(shape=(6, 1), slots=[1, 0, 2, 2, 0, 1]),
         "prefill": dict(shape=(1, 9), slot=2),
         "prefill_base": dict(shape=(1, 5), slot=0)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("tname", ["qkv", "out"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_twin_matches_the_reference_arithmetic(form, tname, dtype):
    f = FORMS[form]
    rng = np.random.default_rng(len(form) * 7 + len(tname) + len(dtype))
    d_out = 3 * HIDDEN if tname == "qkv" else HIDDEN
    layer = 1
    x = rng.normal(0, 1, f["shape"] + (HIDDEN,)).astype(np.float32)
    w = rng.normal(0, 0.2, (HIDDEN, d_out)).astype(np.float32)
    bias = rng.normal(0, 0.1, d_out).astype(np.float32)
    a, b, scale = _factors(rng, HIDDEN, d_out)
    plain, want = _jax_delta(x, w, bias, a, b, scale, tname, layer,
                             slots=f.get("slots"), slot=f.get("slot"),
                             dtype=dtype)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    n = int(np.prod(f["shape"]))
    rows = _torch(x.reshape(n, HIDDEN), tdt)
    y = _torch(plain.reshape(n, d_out), tdt)
    y0 = y.clone()
    idx = torch.tensor(f["slots"], dtype=torch.int32) if "slots" in f \
        else torch.tensor([f["slot"]], dtype=torch.int32).expand(n)
    args = (rows, _torch(a, tdt), _torch(b, tdt), torch.from_numpy(scale),
            idx, layer)
    tol = ld.lora_delta_tol(y0, *args)
    got = ld.lora_delta_reference(y, *args)
    assert got is y and y.dtype == tdt
    diff = (y.float() - torch.tensor(want.reshape(n, d_out))).abs()
    assert bool((diff <= tol).all()), float((diff - tol).max())
    base = idx == 0
    assert torch.equal(y[base].view(torch.int16 if dtype == "bf16"
                                    else torch.int32),
                       y0[base].view(torch.int16 if dtype == "bf16"
                                     else torch.int32))
    if form != "prefill_base":
        assert float((y.float() - y0.float())[~base].abs().max()) > 0.01


def test_base_rows_keep_negative_zero():
    y = torch.tensor([[-0.0, 1.0], [-0.0, 2.0]])
    x = torch.ones(2, 3)
    a = torch.ones(2, 1, 3, 1)
    b = torch.zeros(2, 1, 1, 2)
    out = ld.lora_delta(y, x, a, b, torch.tensor([0.0, 1.0]),
                        torch.tensor([0, 1], dtype=torch.int32), 0)
    # row 1's delta is +0.0: -0.0 + 0.0 rounds to +0.0; row 0 is untouched
    assert torch.signbit(out[0, 0]) and not torch.signbit(out[1, 0])


def test_cpu_route_is_the_twin_and_launches_nothing():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(5)
    a, b, scale = _factors(rng, HIDDEN, HIDDEN)
    x = torch.from_numpy(rng.normal(0, 1, (4, HIDDEN)).astype(np.float32))
    y1 = torch.from_numpy(rng.normal(0, 1, (4, HIDDEN)).astype(np.float32))
    y2 = y1.clone()
    idx = torch.tensor([2, 1, 0, 2], dtype=torch.int32)
    args = (x, torch.from_numpy(a), torch.from_numpy(b),
            torch.from_numpy(scale), idx, 0)
    ld.lora_delta(y1, *args)
    ld.lora_delta_reference(y2, *args)
    assert torch.equal(y1, y2)
    assert kernels.launch_counts()["lora_delta"] == 0


# ---------------------------------------------------------------------------
# the kernel route's refusals, on meta tensors
# ---------------------------------------------------------------------------

def _meta(dtype=torch.bfloat16, n=8, d_in=768, d_out=2304, rank=16):
    dev = "meta"
    return dict(y=torch.empty((n, d_out), dtype=dtype, device=dev),
                x=torch.empty((n, d_in), dtype=dtype, device=dev),
                a=torch.empty((K, 12, d_in, rank), dtype=dtype, device=dev),
                b=torch.empty((K, 12, rank, d_out), dtype=dtype, device=dev),
                scale=torch.empty(K, dtype=torch.float32, device=dev),
                idx=torch.empty(n, dtype=torch.int32, device=dev), layer=3)


def _edit(key, fn):
    def edit(a):
        a[key] = fn(a)
    return edit


REFUSALS = {
    "fp16 activations": (_edit("y", lambda a: a["y"].half()), TypeError),
    "factors of another type": (_edit("a", lambda a: a["a"].float()),
                                TypeError),
    "int64 index": (_edit("idx", lambda a: a["idx"].long()), TypeError),
    "bf16 scale": (_edit("scale", lambda a: a["scale"].bfloat16()),
                   TypeError),
    "strided y columns": (_edit("y", lambda a: torch.empty(
        (8, 2 * 2304), dtype=torch.bfloat16, device="meta")[:, ::2]),
        ValueError),
    "non-contiguous A": (_edit("a", lambda a: a["a"].transpose(2, 3)
                               .contiguous().transpose(2, 3)), ValueError),
    "rows of another count": (_edit("x", lambda a: a["x"][:7]), ValueError),
    "A of another width": (_edit("a", lambda a: a["a"][:, :, :700]
                                 .contiguous()), ValueError),
    "index of another length": (_edit("idx", lambda a: a["idx"][:4]),
                                ValueError),
    "layer out of range": (_edit("layer", lambda a: 12), ValueError),
    "x row past shared memory": (
        lambda a: a.update(_meta(d_in=12288, d_out=768)), ValueError),
    "scale of another length": (_edit("scale", lambda a: a["scale"][:2]),
                                ValueError),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_kernel_route_refuses(name):
    edit, exc = REFUSALS[name]
    args = _meta()
    edit(args)
    with pytest.raises(exc):
        ld.lora_delta(**args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_well_formed_kernel_call_needs_a_card(dtype):
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        ld.lora_delta(**_meta(dtype))
    assert kernels.launch_counts()["lora_delta"] == 0


# ---------------------------------------------------------------------------
# the bound: where the earlier rule failed, and a wrong delta
# ---------------------------------------------------------------------------

def _card_state(n, d_out, dtype, seed, rank):
    """The card check's distribution (chip_smoke.py `_lora_state`): x ~
    N(0, 1), y ~ N(0, 0.25), adapters std 0.05, 12 layers, K = 3."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, 768), generator=g).to(dtype)
    y = (torch.randn((n, d_out), generator=g) * 0.5).to(dtype)
    a = (torch.randn((3, 12, 768, rank), generator=g) * 0.05).to(dtype)
    b = (torch.randn((3, 12, rank, d_out), generator=g) * 0.05).to(dtype)
    a[0] = 0
    b[0] = 0
    return y, x, a, b, torch.tensor([0.0, 1.0, 0.5])


def _one_rounding_tol(y, x, a, b, scale, idx, layer):
    """The earlier rule: each of t, the delta and the sum rounding the other
    way once by 2^-8 (bf16) / 2^-20 (fp32) of its magnitude."""
    eps = 2.0 ** -8 if y.dtype == torch.bfloat16 else 2.0 ** -20
    sel = idx.long()
    t = torch.bmm(x.float()[:, None, :], a[sel, layer].float())
    b_rows = b[sel, layer].float()
    sc = scale[sel].float().abs()[:, None]
    d = torch.bmm(t, b_rows)[:, 0] * sc
    mag = torch.bmm(t.abs(), b_rows.abs())[:, 0] * sc
    return eps * (2 * mag + y.float().abs() + d.abs()) + 1e-30


@pytest.mark.parametrize("dtype, d_out, seed", [(torch.bfloat16, 2304, 8),
                                                (torch.float32, 768, 1)])
def test_bound_holds_where_a_sum_crosses_a_rounding_step(dtype, d_out,
                                                         seed):
    """Rank 4, 1024 rows of one slot (the tile form's shape): the twin's
    fp32 sums and fp64 sums land on the two sides of a rounding step at
    some elements, past the earlier rule; the derived bound holds them all."""
    n = 1024
    y, x, a, b, scale = _card_state(n, d_out, dtype, seed, rank=4)
    args = (x, a, b, scale, torch.tensor([2], dtype=torch.int32).expand(n),
            3)
    twin = ld.lora_delta_reference(y.clone(), *args)
    exact = ld.lora_delta_exact(y, *args)
    diff = (twin.float() - exact.float()).abs()
    assert int((diff > _one_rounding_tol(y, *args)).sum()) > 0
    assert bool((diff <= ld.lora_delta_tol(y, *args)).all())


@pytest.mark.parametrize("mutation", ["rank_column_dropped",
                                      "scale_off_by_2^-5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["decode", "prefill"])
def test_bound_sees_a_wrong_delta(form, dtype, mutation):
    n = 8 if form == "decode" else 1024
    y, x, a, b, scale = _card_state(n, 2304, dtype, seed=5, rank=16)
    idx = torch.tensor([1, 0, 2, 1, 2, 2, 1, 0], dtype=torch.int32) \
        if form == "decode" else \
        torch.tensor([2], dtype=torch.int32).expand(n)
    layer = 3
    tol = ld.lora_delta_tol(y, x, a, b, scale, idx, layer)
    twin = ld.lora_delta_reference(y.clone(), x, a, b, scale, idx, layer)
    if mutation == "rank_column_dropped":
        a = a.clone()
        a[:, layer, :, 5] = 0
    else:
        scale = scale * (1 + 2.0 ** -5)
    wrong = ld.lora_delta_reference(y.clone(), x, a, b, scale, idx, layer)
    assert int(((wrong.float() - twin.float()).abs() > tol).sum()) > 0
