"""Port parity: float16 in the cross-entropy, fused LayerNorm, AdamW update
and adapter-delta kernels' twins, vs the JAX package.

Each kernel has a float16 instantiation on the card (`chip_smoke.py` holds
it to its twin); here the twins, the CPU route, meet the JAX functions on
the same values, made with numpy:

  * cross-entropy on f16 logits (the fused route: the Pallas kernels in
    interpret mode): loss and lse fp32 within 1e-5 (both sum the same f16
    values in fp32), dlogits in f16 within one f16 step (rtol 2e-3, atol
    2e-6 for the many values near 0);
  * fused bias-residual LayerNorm in f16, affine terms in f16 and in fp32:
    one f16 rounding of the same fp32 value, rtol 2e-3, atol 2e-3 (outputs
    of order 1);
  * Adam and AdamW over f16 parameters, without and with fp32 masters, 3
    steps of a schedule: parameters within one f16 step (2^-10 relative),
    moments and masters within fp32 rounding;
  * the adapter delta in f16, decode (a slot a row) and prefill (one slot
    over the rows) forms, both projections: within `lora_delta_tol` of the
    reference's arithmetic, with f16's unit roundoff 2^-11 (and 2^-25
    below its normal range) in place of bf16's, base rows bit for bit.
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor as JTensor
from paddle_tpu.kernels.cross_entropy import \
    fused_softmax_cross_entropy as j_fused_ce
from paddle_tpu.kernels.fused_ln import \
    fused_bias_residual_layer_norm as j_fused_ln
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.serving.tenancy import AdapterSet as JAdapterSet
from paddle_tpu.serving.tenancy import _adapter_forward

from paddle_tpu_torch.kernels import cross_entropy as tce
from paddle_tpu_torch.kernels import fused_ln
from paddle_tpu_torch.kernels import lora_delta as ld
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as tlr

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

F16 = torch.float16


def _f16_np(shape, rng, scale=1.0):
    """Normal values rounded to f16, as float32 numpy (exact)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return x.astype(np.float16).astype(np.float32)


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------

def test_f16_cross_entropy_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    r, v = 40, 3000
    logits = _f16_np((r, v), rng, 2.0)
    labels = rng.integers(0, v, r).astype(np.int32)
    labels[5] = -100
    w = rng.standard_normal(r).astype(np.float32)
    jl = jnp.asarray(logits).astype(jnp.float16)
    jlab, jw = jnp.asarray(labels), jnp.asarray(w)
    j_loss = j_fused_ce(jl, jlab, True)
    j_grad = jax.grad(lambda x: jnp.sum(j_fused_ce(x, jlab, True) * jw))(jl)
    tl = torch.from_numpy(logits).to(F16).requires_grad_(True)
    t_loss = tce.fused_softmax_cross_entropy(tl, torch.from_numpy(labels))
    assert t_loss.dtype == torch.float32
    (t_loss * torch.from_numpy(w)).sum().backward()
    assert tl.grad.dtype == F16
    np.testing.assert_allclose(t_loss.detach().numpy(),
                               np.asarray(j_loss, np.float32),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.grad.float().numpy(),
                               np.asarray(j_grad, np.float32),
                               rtol=2e-3, atol=2e-6)
    # the kernels' own entries: lse in fp32, dlogits in f16
    loss, lse = tce.cross_entropy_fwd(tl.detach(),
                                      torch.from_numpy(labels))
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(
        lse.numpy(), torch.logsumexp(torch.from_numpy(logits), -1).numpy(),
        rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# fused LayerNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("affine", ["float16", "float32"])
def test_f16_fused_ln_matches_pallas_interpret(affine):
    rng = np.random.default_rng(3)
    r, d = 40, 256
    arrs = [_f16_np((r, d), rng), _f16_np((r, d), rng),
            *(_f16_np(d, rng) for _ in range(3))]
    adt = getattr(jnp, affine)
    j_out = j_fused_ln(jnp.asarray(arrs[0], jnp.float16),
                       jnp.asarray(arrs[1], jnp.float16),
                       *(jnp.asarray(a, adt) for a in arrs[2:]), 1e-5, True)
    ts = [torch.from_numpy(a).to(F16) for a in arrs[:2]] + \
        [torch.from_numpy(a).to(getattr(torch, affine)) for a in arrs[2:]]
    out = fused_ln.fused_ln_fwd(*ts)
    assert out.dtype == F16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the AdamW update
# ---------------------------------------------------------------------------

SHAPES = [(7, 13), (768,), (5,), (3, 4, 5), (1,), (2, 8195)]
SKIP = {"w1", "w4"}
STEPS = 3


def _sched(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-2, T_max=6),
                            warmup_steps=2, start_lr=1e-3, end_lr=1e-2)


@pytest.mark.parametrize("multi_precision", [False, True])
@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_f16_update_matches_jax(kind, multi_precision):
    rng = np.random.default_rng(11)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * 1e-2).astype(np.float32)
              for s in SHAPES] for _ in range(STEPS)]
    names = [f"w{i}" for i in range(len(SHAPES))]
    jps = [paddle.nn.Parameter(jnp.asarray(x).astype(jnp.float16), name=n)
           for x, n in zip(params, names)]
    tps = [torch.nn.Parameter(torch.tensor(x, dtype=F16)) for x in params]
    j_sched, t_sched = _sched(jlr), _sched(tlr)
    kw = dict(multi_precision=multi_precision)
    if kind == "adamw":
        jopt = paddle.optimizer.AdamW(
            learning_rate=j_sched, parameters=jps, weight_decay=0.05,
            apply_decay_param_fun=lambda n: n not in SKIP, **kw)
        topt = AdamW(learning_rate=t_sched, parameters=list(zip(names, tps)),
                     weight_decay=0.05,
                     apply_decay_param_fun=lambda n: n not in SKIP, **kw)
    else:
        jopt = paddle.optimizer.Adam(learning_rate=j_sched, parameters=jps,
                                     **kw)
        topt = Adam(learning_rate=t_sched, parameters=tps, **kw)
    for step in range(STEPS):
        jopt._create_accumulators(jps)
        jopt._apply_optimize([(p, JTensor(jnp.asarray(g)
                                          .astype(jnp.float16)))
                              for p, g in zip(jps, grads[step])])
        topt._apply_optimize([(p, torch.from_numpy(g).to(F16))
                              for p, g in zip(tps, grads[step])])
        for tp, jp in zip(tps, jps):
            assert tp.dtype == F16
            np.testing.assert_allclose(
                tp.detach().float().numpy(),
                np.asarray(jp._value.astype(jnp.float32)), rtol=2 ** -10,
                atol=0, err_msg=jp.name)
            for name, slot in topt._accumulators.items():
                if tp not in slot:
                    continue
                assert slot[tp].dtype == torch.float32
                np.testing.assert_allclose(
                    slot[tp].numpy(),
                    np.asarray(jopt._accumulators[name][jp.name]),
                    rtol=1e-6, atol=1e-8, err_msg=f"{jp.name} {name}")
        j_sched.step()
        t_sched.step()
    masters = topt._accumulators.get("master_weight", {})
    assert len(masters) == (len(tps) if multi_precision else 0)


# ---------------------------------------------------------------------------
# the adapter delta
# ---------------------------------------------------------------------------

K, L, R, HIDDEN = 3, 2, 4, 48
FORMS = {"decode": dict(shape=(6, 1), slots=[1, 0, 2, 2, 0, 1]),
         "prefill": dict(shape=(1, 9), slot=2)}


def _jax_delta(x, w, bias, a, b, scale, tname, layer, slots=None,
               slot=None):
    """The reference's f16 projection with its adapter delta, and without
    (tests/test_torch_lora_delta.py `_jax_delta` in f16)."""
    def t(v):
        return jnp.asarray(v).astype(jnp.float16)

    lin = types.SimpleNamespace(weight=paddle.Tensor(t(w)),
                                bias=paddle.Tensor(t(bias)))
    zeros = [jnp.zeros((K, L, 1, 1), jnp.float16)] * 2
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


@pytest.mark.parametrize("tname", ["qkv", "out"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_f16_delta_twin_matches_the_reference_arithmetic(form, tname):
    f = FORMS[form]
    rng = np.random.default_rng(len(form) * 7 + len(tname))
    d_out = 3 * HIDDEN if tname == "qkv" else HIDDEN
    layer = 1
    x = rng.normal(0, 1, f["shape"] + (HIDDEN,)).astype(np.float32)
    w = rng.normal(0, 0.2, (HIDDEN, d_out)).astype(np.float32)
    bias = rng.normal(0, 0.1, d_out).astype(np.float32)
    a = rng.normal(0, 0.3, (K, L, HIDDEN, R)).astype(np.float32)
    b = rng.normal(0, 0.3, (K, L, R, d_out)).astype(np.float32)
    a[0] = b[0] = 0
    scale = np.array([0.0, 2.0, 0.75], np.float32)
    plain, want = _jax_delta(x, w, bias, a, b, scale, tname, layer,
                             slots=f.get("slots"), slot=f.get("slot"))
    n = int(np.prod(f["shape"]))
    y = torch.from_numpy(plain.reshape(n, d_out)).to(F16)
    y0 = y.clone()
    idx = torch.tensor(f["slots"], dtype=torch.int32) if "slots" in f \
        else torch.tensor([f["slot"]], dtype=torch.int32).expand(n)
    args = (torch.from_numpy(x.reshape(n, HIDDEN)).to(F16),
            torch.from_numpy(a).to(F16), torch.from_numpy(b).to(F16),
            torch.from_numpy(scale), idx, layer)
    tol = ld.lora_delta_tol(y0, *args)
    got = ld.lora_delta(y, *args)
    assert got is y and y.dtype == F16
    diff = (y.float() - torch.from_numpy(want.reshape(n, d_out))).abs()
    assert bool((diff <= tol).all()), float((diff - tol).max())
    base = idx == 0
    assert torch.equal(y[base].view(torch.int16), y0[base].view(torch.int16))
    assert float((y.float() - y0.float())[~base].abs().max()) > 0.01


def test_f16_delta_bound_uses_f16_s_roundoff():
    """The f16 bound lies between fp32's and bf16's on the same values,
    and it holds the twin against fp64 sums on the card's distribution
    (1024 rows of one slot, rank 4, the tile form's shape)."""
    from test_torch_lora_delta import _card_state
    n = 1024
    y, x, a, b, scale = _card_state(n, 768, F16, seed=8, rank=4)
    args = (x, a, b, scale, torch.tensor([2], dtype=torch.int32).expand(n),
            3)
    tol16 = ld.lora_delta_tol(y, *args)
    as_bf16 = [t.bfloat16() if getattr(t, "dtype", None) == F16 else t
               for t in (y, *args)]
    as_fp32 = [t.float() if getattr(t, "dtype", None) == F16 else t
               for t in (y, *args)]
    tol_bf16 = ld.lora_delta_tol(*as_bf16)
    tol32 = ld.lora_delta_tol(*as_fp32)
    touched = tol16 > 0
    assert bool((tol32[touched] < tol16[touched]).all())
    assert bool((tol16[touched] < tol_bf16[touched]).all())
    twin = ld.lora_delta_reference(y.clone(), *args)
    exact = ld.lora_delta_exact(y, *args)
    assert bool(((twin.float() - exact.float()).abs() <= tol16).all())
