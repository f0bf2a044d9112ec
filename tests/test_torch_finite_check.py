"""The numeric guard's kernels' twins and the guarded updates, bit for bit
with ``finite_all`` + ``where`` semantics (the reference's
`paddle_tpu/optimizer/optimizer.py:131-197`: one predicate over the
gradients and every new parameter and accumulator, ``where(finite, new,
old)``), on the CPU.

- `adam_update_reference`'s probe sets the flag exactly where
  `finite_all` of the gradients and of `adam_rule`'s new values is false,
  and writes nothing; its gated apply is the plain update where the flag
  is clear and nothing where it is set.
- `multi_tensor_finite_reference` ORs the flag where `finite_all` is
  false and, with a scale, is ``t * scale.to(t.dtype)`` bit for bit;
  `multi_tensor_copy_if_reference` copies where the flag is clear.
- Each optimizer's guarded update (``_update(..., guard="check")``) is,
  bit for bit, ``where(finite_all(grads + new state), new, old)`` of its
  per-tensor rule `_single_update`, over fp32 and bf16 groups at once,
  with the predicate global across the groups.
- `GradScaler` and the guarded update take a parameter made from a
  transposed view (its gradient follows its strides) and a float64 one,
  as the unguarded path does, with the same bits.
- The kernel routes hand their C entries the guard's mode and the dtype
  code, take dense layouts and float64, and refuse other layouts (meta
  tensors, recorded calls): tests/test_torch_float16_codes.py.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import set_flags
from paddle_tpu_torch.kernels import adam_update as au
from paddle_tpu_torch.kernels import finite_check as fc
from paddle_tpu_torch.ops.guardian import finite_all

DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _tensors(seed, dtype, bad=None, shapes=((7, 13), (768,), (5,), (1,))):
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .to(dtype) for s in shapes]
    if bad is not None:
        ts[bad[0]].view(-1)[bad[1]] = bad[2]
    return ts


def _bits(ts):
    return [t.view(torch.int16 if t.element_size() == 2 else torch.int32)
            .clone() for t in ts]


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(_bits(a), _bits(b)))


def _flag(value=0):
    return torch.tensor(value, dtype=torch.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bad", [None, (0, 5, float("nan")),
                                 (3, 0, float("inf")),
                                 (1, 100, float("-inf"))])
def test_finite_twin(dtype, bad):
    ts = _tensors(0, dtype, bad)
    before = [t.clone() for t in ts]
    flag = _flag()
    fc.multi_tensor_finite(ts, flag)
    assert int(flag) == int(not bool(finite_all(ts)))
    assert _same_bits(ts, before)
    # the flag is ORed into, never cleared
    fc.multi_tensor_finite(_tensors(1, dtype), flag)
    assert int(flag) == int(bad is not None)


@pytest.mark.parametrize("dtype", DTYPES)
def test_finite_twin_unscales_bit_for_bit(dtype):
    ts = _tensors(2, dtype, (2, 1, float("inf")))
    mixed = ts + _tensors(3, torch.float32)
    want = [t * (1.0 / torch.tensor(2.0 ** 15)).to(t.dtype) for t in mixed]
    flag = _flag()
    fc.multi_tensor_finite(mixed, flag, 1.0 / torch.tensor(2.0 ** 15))
    assert int(flag) == 1
    assert _same_bits(mixed, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("set_", [0, 1])
def test_copy_if_twin(dtype, set_):
    dst, src = _tensors(4, dtype), _tensors(5, dtype)
    before = [t.clone() for t in dst]
    fc.multi_tensor_copy_if(dst, src, _flag(set_))
    assert _same_bits(dst, before if set_ else src)


def test_finite_twin_float64_range():
    """A float64 value past fp32's range is finite; an inf is not."""
    ts = [torch.tensor([1e300, -1e-300], dtype=torch.float64)]
    flag = _flag()
    fc.multi_tensor_finite(ts, flag, 1.0 / torch.tensor(2.0 ** 15))
    assert int(flag) == 0
    assert torch.equal(ts[0], torch.tensor([1e300, -1e-300],
                                           dtype=torch.float64)
                       * (1.0 / torch.tensor(2.0 ** 15)).double())
    ts[0][1] = float("-inf")
    fc.multi_tensor_finite(ts, flag)
    assert int(flag) == 1


def test_refusals():
    ts = _tensors(0, torch.float32)
    with pytest.raises(ValueError, match="flag"):
        fc.multi_tensor_finite(ts, torch.tensor(0))
    with pytest.raises(ValueError, match="scale"):
        fc.multi_tensor_finite(ts, _flag(), torch.tensor(1.0,
                                                         dtype=torch.float64))
    with pytest.raises(ValueError, match="copy of"):
        fc.multi_tensor_copy_if(ts[:1], ts[1:2], _flag())
    with pytest.raises(ValueError, match="guard"):
        au.adam_update(ts, ts, ts, ts, [None] * 4, [False] * 4,
                       torch.tensor(1e-3), torch.tensor(1.0), 0.9, 0.999,
                       1e-8, 0.0, guard="probe")


def _adam_state(seed, dtype, masters, lr_scale=1.0):
    ps = _tensors(seed, dtype)
    gs = [g * 1e-2 for g in _tensors(seed + 1, dtype)]
    m1 = [t.abs() * 1e-3 for t in _tensors(seed + 2, torch.float32)]
    m2 = [t.abs() * 1e-5 for t in _tensors(seed + 3, torch.float32)]
    mw = [p.float() + 1e-3 if masters else None for p in ps]
    return ps, gs, m1, m2, mw


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masters", [False, True])
@pytest.mark.parametrize("poison", ["none", "grad", "lr"])
def test_adam_twin_probe_and_apply(dtype, masters, poison):
    state = _adam_state(7, dtype, masters)
    ps, gs, m1, m2, mw = state
    if poison == "grad":
        gs[2].view(-1)[3] = float("nan")
    lr = torch.tensor(float("inf") if poison == "lr" else 1e-3)
    t = torch.tensor(3.0)
    decays = [True, False, True, False]
    args = (0.9, 0.999, 1e-8, 0.01)
    new = [au.adam_rule(p, g, a, b, w, lr, t, *args[:3], args[3], d)
           for p, g, a, b, w, d in zip(ps, gs, m1, m2, mw, decays)]
    vals = list(gs) + [v for row in new for v in row if v is not None]
    finite = bool(finite_all(vals))
    assert finite == (poison == "none")
    kept = [[None if x is None else x.clone() for x in xs] for xs in state]
    flag = _flag()
    au.adam_update(ps, gs, m1, m2, mw, decays, lr, t, *args, guard="probe",
                   flag=flag)
    assert int(flag) == int(not finite)
    for xs, ys in zip(state, kept):
        assert _same_bits([x for x in xs if x is not None],
                          [y for y in ys if y is not None])
    au.adam_update(ps, gs, m1, m2, mw, decays, lr, t, *args, guard="apply",
                   flag=flag)
    for i, (p, g, a, b, w, d) in enumerate(zip(*kept, decays)):
        want_p, want_a, want_b, want_w = new[i] if finite else (p, a, b, w)
        assert _same_bits([ps[i], m1[i], m2[i]], [want_p, want_a, want_b])
        if w is not None:
            assert _same_bits([mw[i]], [want_w])


# -- every optimizer's guarded update -----------------------------------------

OPTIMIZERS = {
    "sgd": lambda ps: topt.SGD(learning_rate=0.1, parameters=ps),
    "momentum": lambda ps: topt.Momentum(learning_rate=0.1, momentum=0.9,
                                         use_nesterov=True, parameters=ps),
    "adam": lambda ps: topt.Adam(learning_rate=1e-3, parameters=ps,
                                 multi_precision=True),
    "adamw": lambda ps: topt.AdamW(learning_rate=1e-3, parameters=ps),
    "lamb": lambda ps: topt.Lamb(learning_rate=1e-2, parameters=ps),
    "rmsprop": lambda ps: topt.RMSProp(learning_rate=1e-3, centered=True,
                                       momentum=0.5, parameters=ps),
    "adagrad": lambda ps: topt.Adagrad(learning_rate=1e-2, parameters=ps),
    "adadelta": lambda ps: topt.Adadelta(learning_rate=1.0, parameters=ps),
    "adamax": lambda ps: topt.Adamax(learning_rate=1e-3, parameters=ps),
    "lars": lambda ps: topt.Lars(learning_rate=1.0, parameters=ps),
}


def _params(seed):
    """Two fp32 and two bf16 parameters (two groups)."""
    return [torch.nn.Parameter(t) for t in
            _tensors(seed, torch.float32, shapes=((4, 6), (6,)))
            + _tensors(seed + 1, torch.bfloat16, shapes=((3, 5), (5,)))]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("poison", ["none", "bf16_grad", "fp32_grad", "lr"])
def test_guarded_update_is_where_of_the_rule(name, poison):
    ps = _params(11)
    opt = OPTIMIZERS[name](ps)
    gs = [g * 1e-1 for g in _tensors(13, torch.float32, shapes=((4, 6), (6,)))
          + _tensors(14, torch.bfloat16, shapes=((3, 5), (5,)))]
    if poison == "bf16_grad":
        gs[3][1] = float("inf")
    elif poison == "fp32_grad":
        gs[0][2, 2] = float("nan")
    # a step first, so the accumulators hold values of their own
    pairs = list(zip(ps, [g.clone() for g in gs]))
    with torch.no_grad():
        opt._apply_optimize(pairs if poison == "none" else
                            list(zip(ps, [torch.zeros_like(g)
                                          for g in gs])))
    if poison == "lr":
        opt.set_lr(float("inf"))
    opt._begin_step({torch.device("cpu")})
    lr, t = opt._device_scalars("cpu")
    accs = opt._accumulators
    old = {p: (p.detach().clone(), {n: s[p].clone() for n, s in accs.items()
                                    if p in s}) for p in ps}
    rule = [opt._single_update(old[p][0], g, old[p][1], lr, t)
            for p, g in zip(ps, gs)]
    vals = list(gs) + [v for new_p, new_a in rule
                       for v in [new_p, *new_a.values()]]
    finite = bool(finite_all(vals))
    assert finite == (poison == "none")
    with torch.no_grad():
        opt._update(list(zip(ps, gs)), guard="check")
    assert int(opt._guard_flag("cpu")) == int(not finite)
    for p, (new_p, new_a) in zip(ps, rule):
        want_p, want_a = (new_p, new_a) if finite else old[p]
        assert _same_bits([p.detach()], [want_p.to(p.dtype)]), (name, p.shape)
        for n in want_a:
            assert _same_bits([accs[n][p]], [want_a[n].to(accs[n][p].dtype)]
                              ), (name, n)


def _layout_params(seed):
    """A parameter made from a transposed view and a float64 one."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(5))
    return [torch.nn.Parameter(w.t()), torch.nn.Parameter(b)]


@pytest.mark.parametrize("guard", [False, True])
def test_scaler_and_guard_take_transposed_and_float64(guard):
    """Three O1-style scaler steps of Momentum over `_layout_params`, the
    second with an inf gradient: the same bits as the unscaled update of
    a plain Momentum, guard on or off, and the bad step moves nothing."""
    x = torch.linspace(-1, 1, 6)
    y = torch.linspace(0, 2, 5, dtype=torch.float64)
    ps, plain = _layout_params(0), _layout_params(0)
    opt = topt.Momentum(learning_rate=0.1, momentum=0.9, parameters=ps)
    ref = topt.Momentum(learning_rate=0.1, momentum=0.9, parameters=plain)
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
    set_flags({"FLAGS_check_numerics": guard})
    try:
        for step in range(3):
            loss = (ps[0] @ x).sum() + (ps[1] * y).sum()
            scaler.scale(loss).backward()
            assert not ps[0].grad.is_contiguous()
            assert ps[0].grad.stride() == ps[0].stride()
            if step == 1:
                ps[1].grad[2] = float("inf")
            inv = 1.0 / torch.tensor(2.0 ** 10)
            grads = [p.grad * inv.to(p.dtype) for p in ps]
            before = [p.detach().clone() for p in ps]
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            if step == 1:
                assert all(torch.equal(p.detach(), b)
                           for p, b in zip(ps, before))
                continue
            for p, g in zip(plain, grads):
                p.grad = g
            ref.step()
            ref.clear_grad()
            assert all(torch.equal(p.detach(), q.detach())
                       for p, q in zip(ps, plain)), step
    finally:
        set_flags({"FLAGS_check_numerics": False})
    assert opt._step_count == (3 if guard else 2)
