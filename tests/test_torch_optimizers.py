"""Port parity: the optimizers, the regularizers, the clip and regularizer
inside `TrainStep`, and optimizer state, against the JAX package.

- Each optimizer's 10-step eager trajectory (``loss.backward();
  opt.step()``) on a tiny GPT (2 layers, hidden 64, from the same weights
  and batch), losses and parameters, and each regularizer on its own.
- `_update` (the multi-tensor path) bit for bit with `_single_update` (the
  per-tensor rule), fp32 and bf16 parameters.
- `TrainStep` with `ClipGradByGlobalNorm` + `L2Decay`: bit for bit with
  the port's own eager step, within tolerance of the JAX eager loop; the
  JAX `TrainStep` leaves both out (a reference fault, ROADMAP.md Queue 3).
- `TrainStep` with every optimizer bit for bit with the eager step.
- `state_dict` / `set_state_dict` round trips into a step that ran before
  the load; `convert.load_jax_optimizer_state` continues a JAX run.

Tolerances, fp32: losses 1e-5 relative and absolute (the same sums in
another order; XLA on the CPU also contracts the reference's arithmetic
into FMAs, so ulps, not bits, against the JAX package). Parameters
``OPTIMIZERS[name][1]`` absolute after 10 steps, each at most a tenth of
what the run moves a parameter (asserted): Momentum, RMSProp, Adagrad and
Adadelta move each element by an amount proportional to its gradient,
whose rounding differences (1e-7 relative) stay below 1e-6 (SGD at lr
0.1; at lr 0.5 the loss landscape amplifies them to 4e-6 in 10 steps).
Adam and Adamax step about lr * sign(m) (lr 1e-4), so only
a gradient element within rounding of 0 could differ by up to 2 lr; the
tolerance is a tenth of a step, 1e-5 (as `test_torch_train.py` holds
AdamW). Lamb and Lars scale each tensor's step by a ratio of norms, which
`torch.linalg.vector_norm` / `torch._foreach_norm` and `jnp.linalg.norm`
(Lars: ``sqrt(sum(x * x))``) sum in different orders (a few fp32 ulps of
the norm), so their steps differ by that relative amount: 2e-6.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.models import \
    GPTPretrainingCriterion as JGPTPretrainingCriterion
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.optimizer import regularizer as jreg

from paddle_tpu_torch import optimizer as topt_mod
from paddle_tpu_torch.convert import load_jax_optimizer_state
from paddle_tpu_torch.incubate.models import GPTPretrainingCriterion
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.optimizer import regularizer as treg

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import _batch, _jax_params, _pair

STEPS = 10
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


def _rms_centered(mod):
    return dict(cls=mod.RMSProp, learning_rate=1e-3, rho=0.9,
                momentum=0.5, centered=True)


# name -> (constructor kwargs for a module (jax or port), parameter atol)
OPTIMIZERS = {
    "sgd": (lambda m: dict(cls=m.SGD, learning_rate=0.1), 1e-6),
    "sgd_l2": (lambda m: dict(cls=m.SGD, learning_rate=0.1,
                              weight_decay=0.1), 1e-6),
    "momentum": (lambda m: dict(cls=m.Momentum, learning_rate=0.1,
                                momentum=0.9), 1e-6),
    "nesterov": (lambda m: dict(cls=m.Momentum, learning_rate=0.1,
                                momentum=0.9, use_nesterov=True), 1e-6),
    "lamb": (lambda m: dict(cls=m.Lamb, learning_rate=1e-2,
                            lamb_weight_decay=0.01,
                            exclude_from_weight_decay_fn=lambda p:
                            len(p.shape) <= 1), 2e-6),
    "rmsprop": (lambda m: dict(cls=m.RMSProp, learning_rate=1e-3), 1e-6),
    "rmsprop_centered": (_rms_centered, 1e-6),
    "adagrad": (lambda m: dict(cls=m.Adagrad, learning_rate=1e-2,
                               initial_accumulator_value=0.1), 1e-6),
    "adadelta": (lambda m: dict(cls=m.Adadelta, learning_rate=1.0,
                                rho=0.9), 1e-6),
    "adamax": (lambda m: dict(cls=m.Adamax, learning_rate=1e-4), 1e-5),
    "lars": (lambda m: dict(cls=m.Lars, learning_rate=1.0, momentum=0.9,
                            lars_coeff=0.01, lars_weight_decay=5e-3,
                            exclude_from_weight_decay=["bias"]), 2e-6),
    "adam_l1": (lambda m: dict(cls=m.Adam, learning_rate=1e-4,
                               weight_decay=_decay(m, "L1Decay", 1e-3)),
                1e-5),
    "adam_l2": (lambda m: dict(cls=m.Adam, learning_rate=1e-4,
                               weight_decay=_decay(m, "L2Decay", 1e-2)),
                1e-5),
}


def _decay(mod, name, coeff):
    reg = jreg if mod is paddle.optimizer else treg
    return getattr(reg, name)(coeff)


def _make(mod, name, params, **extra):
    kw = dict(OPTIMIZERS[name][0](mod), **extra)
    return kw.pop("cls")(parameters=params, **kw)


def _eager_steps(model, crit, opt, x, y, steps, backward):
    losses = []
    for _ in range(steps):
        loss = crit(model(x), y)
        backward(loss)
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach() if hasattr(loss, "detach")
                            else loss))
    return losses


def _assert_params(jm, tm, atol, rtol=0.0):
    want = _jax_params(jm, tm)
    for name, tp in tm.named_parameters():
        np.testing.assert_allclose(tp.detach().float().numpy(), want[name],
                                   rtol=rtol, atol=atol, err_msg=name)


def _nonzero_pair(seed=10):
    """`_pair`, with the parameters that start at 0 (biases, LayerNorm
    shifts) set to N(0, 0.02) on both sides: L1Decay's sign(p) of a
    parameter that sits at 0 follows rounding noise (the key bias's
    gradient is 0 up to rounding), which Adam's normalized step turns
    into moves of lr either way."""
    jm, tm = _pair(128, 4)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for jp, tp in zip(jm.parameters(), tm.parameters()):
            if not tp.detach().any():
                value = rng.normal(0, 0.02, tp.shape).astype(np.float32)
                jp.set_value(value)
                tp.copy_(torch.from_numpy(value))
    return jm, tm


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_eager_trajectory_matches_jax(name):
    jm, tm = _nonzero_pair()
    jopt = _make(paddle.optimizer, name, jm.parameters())
    topt = _make(topt_mod, name, tm.parameters())
    ids, labels = _batch(128, seed=11)
    jx, jy = paddle.to_tensor(ids), paddle.to_tensor(labels)
    tx, ty = torch.from_numpy(ids), torch.from_numpy(labels)
    before = [p.detach().clone() for p in tm.parameters()]
    j_losses = _eager_steps(jm, JGPTPretrainingCriterion(), jopt, jx, jy,
                            STEPS, lambda loss: loss.backward())
    t_losses = _eager_steps(tm, GPTPretrainingCriterion(), topt, tx, ty,
                            STEPS, lambda loss: loss.backward())
    np.testing.assert_allclose(t_losses, j_losses, **LOSS_TOL)
    assert t_losses[-1] < t_losses[0]
    assert topt._step_count == jopt._step_count == STEPS
    _assert_params(jm, tm, OPTIMIZERS[name][1])
    moved = max(float((p.detach() - b).abs().max())
                for p, b in zip(tm.parameters(), before))
    # each tolerance is at most a tenth of the largest move
    assert moved >= 10 * OPTIMIZERS[name][1], moved


def _state(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    ps = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .to(dtype) for s in shapes]
    gs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
          .to(dtype) for s in shapes]
    return ps, gs


SHAPES = [(5, 7), (13,), (2, 3, 4), (1,), (64, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_is_single_update_bit_for_bit(name, dtype):
    """Three updates of five tensors: `_update` over the list and
    `_single_update` tensor by tensor (the regularizer applied before
    either) give the same bits, parameters and accumulators; a zero
    tensor exercises the norms' zero branches."""
    ps, gs = _state(SHAPES, dtype, seed=12)
    ps[3].zero_()
    single = [p.clone() for p in ps]
    a = _make(topt_mod, name, [torch.nn.Parameter(p) for p in ps])
    b = _make(topt_mod, name, [torch.nn.Parameter(p) for p in single])
    pa, pb = a._parameter_list, b._parameter_list
    for step in range(1, 4):
        gsa = [g * step for g in gs]
        a._apply_optimize(a._prepare(list(zip(pa, gsa))))
        b._create_accumulators(pb)
        b._step_count += 1
        pairs = b._prepare(list(zip(pb, gsa)))
        with torch.no_grad():
            for p, g in pairs:
                accs = {k: v[p] for k, v in b._accumulators.items() if p in v}
                new_p, new_accs = b._single_update(p, g, accs, b.get_lr(),
                                                   b._step_count)
                p.copy_(new_p)
                for k, v in new_accs.items():
                    b._accumulators[k][p].copy_(v)
    for i, (x, y) in enumerate(zip(pa, pb)):
        assert x.dtype == dtype
        assert torch.equal(x, y), (name, i, (x - y).abs().max())
        for k, slot in a._accumulators.items():
            if x in slot:
                assert torch.equal(slot[x], b._accumulators[k][y]), \
                    (name, k, i)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("kind", ["L1Decay", "L2Decay"])
def test_regularizers_match_jax(kind, dtype):
    """`apply` on the same arrays (the term in the gradient's dtype),
    a parameter's own regularizer overriding the optimizer's, and
    `apply_all` over a list, which must equal `apply` pair by pair."""
    rng = np.random.default_rng(13)
    p = rng.standard_normal((6, 5)).astype(np.float32)
    p[0, 0] = 0.0
    g = rng.standard_normal((6, 5)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = "bfloat16" if dtype == "bfloat16" else "float32"
    jp = paddle.create_parameter(p.shape, "float32")
    jp.set_value(p)
    jg = paddle.to_tensor(g).astype(jdt)
    tp = torch.nn.Parameter(torch.from_numpy(p))
    tg = torch.from_numpy(g).to(tdt)
    jr, tr = getattr(jreg, kind)(0.25), getattr(treg, kind)(0.25)
    got, want = tr.apply(tp, tg), jr.apply(jp, jg)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want._value.astype("float32")))
    # the parameter's own regularizer wins over the optimizer's
    other_j, other_t = jreg.L2Decay(3.0), treg.L2Decay(3.0)
    jp.regularizer, tp.regularizer = other_j, other_t
    got, want = tr.apply(tp, tg), jr.apply(jp, jg)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want._value.astype("float32")))
    bare = torch.nn.Parameter(torch.from_numpy(p * 2))
    pairs = treg.apply_all(tr, [(tp, tg), (bare, tg), (bare, None)])
    assert torch.equal(pairs[0][1], other_t.apply(tp, tg))
    assert torch.equal(pairs[1][1], tr.apply(bare, tg))
    assert pairs[2][1] is None


def _clip_l2(mod, clip_mod, params):
    return mod.Momentum(learning_rate=0.05, momentum=0.9, parameters=params,
                        weight_decay=_decay(mod, "L2Decay", 1e-2),
                        grad_clip=clip_mod.ClipGradByGlobalNorm(0.5))


def test_train_step_with_clip_and_l2_matches_jax_eager():
    """The clip binds (the gradient norm is above 0.5 at every step), the
    regularizer is on: TrainStep equals the port's eager step bit for bit
    and the JAX eager loop within the losses' and 1e-6 of the
    parameters."""
    jm, tm = _pair(128, 4)
    _, tm2 = _pair(128, 4)
    ids, labels = _batch(128, seed=14)
    tx, ty = torch.from_numpy(ids), torch.from_numpy(labels)
    t_opt = _clip_l2(topt_mod, tclip, tm.parameters())
    step = TrainStep(tm, GPTPretrainingCriterion(), t_opt)
    g_losses = [float(step(tx, ty)) for _ in range(STEPS)]
    norms = []
    e_opt = _clip_l2(topt_mod, tclip, tm2.parameters())
    e_losses = []
    for _ in range(STEPS):
        loss = GPTPretrainingCriterion()(tm2(tx), ty)
        loss.backward()
        norms.append(float(torch.sqrt(sum(
            (p.grad.float() ** 2).sum() for p in tm2.parameters()))))
        e_opt.step()
        e_opt.clear_grad()
        e_losses.append(float(loss.detach()))
    assert g_losses == e_losses
    assert min(norms) > 0.5, norms
    for a, b in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(a, b)
    for k in t_opt._accumulators:
        for a, b in zip(tm.parameters(), tm2.parameters()):
            assert torch.equal(t_opt._accumulators[k][a],
                               e_opt._accumulators[k][b])
    jopt = _clip_l2(paddle.optimizer, jclip, jm.parameters())
    j_losses = _eager_steps(jm, JGPTPretrainingCriterion(), jopt,
                            paddle.to_tensor(ids), paddle.to_tensor(labels),
                            STEPS, lambda loss: loss.backward())
    np.testing.assert_allclose(g_losses, j_losses, **LOSS_TOL)
    _assert_params(jm, tm, 1e-6)


def test_jax_train_step_leaves_out_clip_and_regularizer():
    """The reference fault the port's TrainStep does not copy: the JAX
    TrainStep's parameters differ from its own eager loop's with the same
    clip and regularizer, and equal (within rounding) those of a run with
    neither."""
    ids, labels = _batch(128, seed=14)
    x, y = paddle.to_tensor(ids), paddle.to_tensor(labels)
    crit = JGPTPretrainingCriterion()
    runs = {}
    for kind in ("step", "eager", "plain"):
        jm, _ = _pair(128, 4)
        if kind == "plain":
            opt = paddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                            parameters=jm.parameters())
        else:
            opt = _clip_l2(paddle.optimizer, jclip, jm.parameters())
        if kind == "eager":
            _eager_steps(jm, crit, opt, x, y, 3, lambda loss: loss.backward())
        else:
            step = JTrainStep(jm, lambda o, t: crit(o, t), opt)
            for _ in range(3):
                step(x, y)
        runs[kind] = [np.asarray(p._value) for p in jm.parameters()]
    gap = max(float(np.abs(a - b).max())
              for a, b in zip(runs["step"], runs["eager"]))
    same = max(float(np.abs(a - b).max())
               for a, b in zip(runs["step"], runs["plain"]))
    assert gap > 1e-3 and same < 1e-6, (gap, same)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_train_step_equals_eager_step(name):
    """Every optimizer through TrainStep (a ClipGradByGlobalNorm(1.0) on
    top) equals ``loss.backward(); opt.step()`` bit for bit after three
    steps."""
    _, tm = _pair(128, 4)
    _, tm2 = _pair(128, 4)
    clip = dict(grad_clip=tclip.ClipGradByGlobalNorm(1.0))
    step = TrainStep(tm, GPTPretrainingCriterion(),
                     _make(topt_mod, name, tm.parameters(), **clip))
    opt = _make(topt_mod, name, tm2.parameters(), **clip)
    ids, labels = _batch(128, seed=15)
    tx, ty = torch.from_numpy(ids), torch.from_numpy(labels)
    g = [float(step(tx, ty)) for _ in range(3)]
    e = _eager_steps(tm2, GPTPretrainingCriterion(), opt, tx, ty, 3,
                     lambda loss: loss.backward())
    assert g == e
    for a, b in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(a, b)


def _scheduled(mod, params):
    sched = mod.lr.StepDecay(1e-2, step_size=2, gamma=0.5)
    return mod.Lamb(learning_rate=sched, parameters=params), sched


def test_state_dict_round_trip_into_a_step_built_before_the_load():
    """Run A trains 5 steps. Run B trains 2, then loads A's model and
    optimizer state after its 3rd (accumulators, schedule, step count)
    into the objects its TrainStep already holds; the accumulators keep
    their storage (a captured graph reads those addresses) and B's next
    two steps equal A's 4th and 5th bit for bit."""
    ids, labels = _batch(128, seed=16)
    tx, ty = torch.from_numpy(ids), torch.from_numpy(labels)
    crit = GPTPretrainingCriterion()
    _, ma = _pair(128, 4)
    oa, sa = _scheduled(topt_mod, ma.named_parameters())
    step_a = TrainStep(ma, crit, oa)
    losses_a, saved = [], None
    for i in range(5):
        losses_a.append(float(step_a(tx, ty)))
        sa.step()
        if i == 2:
            saved = (ma.state_dict(), oa.state_dict())
            saved = ({k: v.clone() for k, v in saved[0].items()}, saved[1])
            saved_sched = sa.state_dict()
    _, mb = _pair(128, 4)
    ob, sb = _scheduled(topt_mod, mb.named_parameters())
    step_b = TrainStep(mb, crit, ob)
    for _ in range(2):
        step_b(tx, ty)
        sb.step()
    ptrs = {k: [t.data_ptr() for t in v.values()]
            for k, v in ob._accumulators.items()}
    assert set(saved[1]) >= {"gpt.wte.weight_moment1", "LR_Scheduler",
                             "_step_count"}
    mb.load_state_dict(saved[0])
    ob.set_state_dict(saved[1])
    assert {k: [t.data_ptr() for t in v.values()]
            for k, v in ob._accumulators.items()} == ptrs
    assert ob._step_count == 3 and sb.state_dict() == saved_sched
    losses_b = []
    for _ in range(2):
        losses_b.append(float(step_b(tx, ty)))
        sb.step()
    assert losses_b == losses_a[3:]
    for a, b in zip(ma.parameters(), mb.parameters()):
        assert torch.equal(a, b)


def test_positional_names_without_named_parameters():
    _, tm = _pair(128, 4)
    opt = topt_mod.Momentum(learning_rate=0.1, parameters=tm.parameters())
    loss = GPTPretrainingCriterion()(tm(torch.zeros(1, 4, dtype=torch.long)),
                                     torch.ones(1, 4, dtype=torch.long))
    opt.minimize(loss)
    state = opt.state_dict()
    n = len(list(tm.parameters()))
    assert sorted(state) == sorted([f"param_{i}_velocity" for i in range(n)]
                                   + ["_step_count"])
    assert state["_step_count"] == 1
    opt.clear_gradients()
    assert all(p.grad is None for p in tm.parameters())


def test_load_jax_optimizer_state_continues_a_jax_run():
    """JAX trains 3 steps with AdamW under a schedule; the port takes its
    weights and optimizer state (moments transposed with the Linear
    weights, the step count, the schedule's state by hand), and both
    continue 3 steps through TrainStep within the usual tolerances."""
    jm, tm = _pair(128, 4)
    j_sched = jlr.StepDecay(1e-3, step_size=2, gamma=0.5)
    t_sched = tlr.StepDecay(1e-3, step_size=2, gamma=0.5)
    jopt = paddle.optimizer.AdamW(learning_rate=j_sched,
                                  parameters=jm.parameters())
    topt = topt_mod.AdamW(learning_rate=t_sched, parameters=tm.parameters())
    jcrit = JGPTPretrainingCriterion()
    jstep = JTrainStep(jm, lambda o, y: jcrit(o, y), jopt)
    ids, labels = _batch(128, seed=17)
    jx, jy = paddle.to_tensor(ids), paddle.to_tensor(labels)
    for _ in range(3):
        jstep(jx, jy)
        j_sched.step()
    from paddle_tpu_torch.convert import load_jax_state
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    load_jax_optimizer_state(topt, tm, jopt, jm)
    t_sched.set_state_dict(j_sched.state_dict())
    assert topt._step_count == 3 and topt.get_lr() == jopt.get_lr()
    tstep = TrainStep(tm, GPTPretrainingCriterion(), topt)
    tx, ty = torch.from_numpy(ids), torch.from_numpy(labels)
    t_losses, j_losses = [], []
    for _ in range(3):
        t_losses.append(float(tstep(tx, ty)))
        j_losses.append(float(jstep(jx, jy)))
        t_sched.step()
        j_sched.step()
    np.testing.assert_allclose(t_losses, j_losses, **LOSS_TOL)
    _assert_params(jm, tm, 1e-5)
