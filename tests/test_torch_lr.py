"""Port parity: the learning-rate schedulers of paddle_tpu_torch against the
JAX package's (`paddle_tpu/optimizer/lr.py`), and the optimizer's lr
surface (`get_lr`, `set_lr`, `set_lr_scheduler`).

Both sides are plain Python on doubles, so every value is compared for
equality (or within 1e-12 relative, which none needs today) over 30
``step()`` calls: each of the fifteen classes, `LinearWarmup` around
another scheduler, `ReduceOnPlateau` fed one metric sequence, and a
``state_dict`` round trip part-way through a schedule.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30
REL = 1e-12

# (class name, args, kwargs); those of tests/test_optimizer.py's scheduler
# test first
CASES = [
    ("StepDecay", (0.1,), dict(step_size=2, gamma=0.5)),
    ("CosineAnnealingDecay", (1.0,), dict(T_max=10)),
    ("LinearWarmup", (0.1,), dict(warmup_steps=4, start_lr=0.0, end_lr=0.1)),
    ("NoamDecay", (), dict(d_model=512, warmup_steps=100, learning_rate=1.0)),
    ("ExponentialDecay", (0.1,), dict(gamma=0.9)),
    ("NaturalExpDecay", (0.1,), dict(gamma=0.05)),
    ("InverseTimeDecay", (0.1,), dict(gamma=0.3)),
    ("PolynomialDecay", (0.1,), dict(decay_steps=12, end_lr=1e-3, power=2.0)),
    ("PolynomialDecay", (0.1,), dict(decay_steps=7, cycle=True)),
    ("PiecewiseDecay", (), dict(boundaries=[3, 8, 20],
                                values=[0.1, 0.05, 0.01, 0.001])),
    ("CosineAnnealingDecay", (0.02,), dict(T_max=7, eta_min=1e-4)),
    ("MultiStepDecay", (0.1,), dict(milestones=[5, 9, 25], gamma=0.3)),
    ("StepDecay", (0.05,), dict(step_size=4)),
    ("LambdaDecay", (0.1,), dict(lr_lambda=lambda e: 0.95 ** e)),
    ("MultiplicativeDecay", (0.1,), dict(lr_lambda=lambda e: 0.9)),
    ("OneCycleLR", (0.1,), dict(total_steps=25)),
    ("OneCycleLR", (0.05,), dict(total_steps=20, anneal_strategy="linear",
                                 phase_pct=0.4, divide_factor=10.0)),
    ("CyclicLR", (0.01, 0.1), dict(step_size_up=4)),
    ("CyclicLR", (0.01, 0.1), dict(step_size_up=3, step_size_down=5,
                                   mode="triangular2")),
    ("CyclicLR", (0.01, 0.1), dict(step_size_up=4, mode="exp_range",
                                   exp_gamma=0.97)),
    ("CyclicLR", (0.01, 0.1), dict(step_size_up=2, mode="custom",
                                   scale_fn=lambda c: 1 / c,
                                   scale_mode="cycle")),
    ("NoamDecay", (), dict(d_model=64, warmup_steps=5, learning_rate=2.0,
                           last_epoch=3)),
]


def _ids(case):
    return f"{case[0]}-{sorted(case[2])}"


def _pair(name, args, kwargs):
    return (getattr(jlr, name)(*args, **kwargs),
            getattr(tlr, name)(*args, **kwargs))


def _assert_equal(t_vals, j_vals):
    np.testing.assert_allclose(t_vals, j_vals, rtol=REL, atol=0)


def _trajectory(s, steps=STEPS):
    vals = [s()]
    for _ in range(steps):
        s.step()
        vals.append(s())
    return vals


def test_every_class_is_ported():
    assert sorted(tlr.__all__) == sorted(jlr.__all__)
    covered = {name for name, _, _ in CASES} | {"LRScheduler",
                                                 "ReduceOnPlateau"}
    assert covered == set(jlr.__all__)


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_schedule_matches_jax(case):
    j, t = _pair(*case)
    j_vals, t_vals = _trajectory(j), _trajectory(t)
    _assert_equal(t_vals, j_vals)
    assert t.last_epoch == j.last_epoch


@pytest.mark.parametrize("inner", ["CosineAnnealingDecay", "StepDecay",
                                   "ExponentialDecay"])
def test_linear_warmup_around_a_scheduler(inner):
    kw = {"CosineAnnealingDecay": dict(T_max=12),
          "StepDecay": dict(step_size=3, gamma=0.5),
          "ExponentialDecay": dict(gamma=0.8)}[inner]
    j = jlr.LinearWarmup(getattr(jlr, inner)(0.1, **kw), warmup_steps=5,
                         start_lr=0.001, end_lr=0.1)
    t = tlr.LinearWarmup(getattr(tlr, inner)(0.1, **kw), warmup_steps=5,
                         start_lr=0.001, end_lr=0.1)
    _assert_equal(_trajectory(t), _trajectory(j))
    assert t.inner.last_epoch == j.inner.last_epoch


@pytest.mark.parametrize("mode,threshold_mode", [("min", "rel"),
                                                 ("min", "abs"),
                                                 ("max", "rel")])
def test_reduce_on_plateau_with_a_metric_sequence(mode, threshold_mode):
    rng = np.random.default_rng(3)
    drift = -1.0 if mode == "min" else 1.0
    metrics = [5.0 + drift * 0.05 * min(i, 10) + 0.02 * rng.standard_normal()
               for i in range(STEPS)]
    kw = dict(mode=mode, factor=0.5, patience=2, threshold=1e-3,
              threshold_mode=threshold_mode, cooldown=1, min_lr=1e-4)
    j, t = jlr.ReduceOnPlateau(0.1, **kw), tlr.ReduceOnPlateau(0.1, **kw)
    j_vals, t_vals = [], []
    for i, m in enumerate(metrics):
        # a tensor metric on the port's side, as a training loop hands it
        j.step(m)
        t.step(torch.tensor(m, dtype=torch.float64) if i % 2 else m)
        j_vals.append(j())
        t_vals.append(t())
    t.step()                       # no metric: nothing moves
    _assert_equal(t_vals, j_vals)
    assert t.last_epoch == j.last_epoch == STEPS
    assert len(set(t_vals)) > 1    # the sequence did reduce the lr


@pytest.mark.parametrize("case", [CASES[1], CASES[15], CASES[19]],
                         ids=["cosine", "one_cycle", "cyclic_exp"])
def test_state_dict_round_trip(case):
    j, t = _pair(*case)
    for s in (j, t):
        for _ in range(11):
            s.step()
    t_state, j_state = t.state_dict(), j.state_dict()
    assert t_state == j_state
    # a fresh scheduler loaded from the state continues where it was
    _, fresh = _pair(*case)
    fresh.set_state_dict(dict(t_state))
    _assert_equal(_trajectory(fresh, 10), _trajectory(j, 10))


def test_linear_warmup_state_dict_carries_the_inner_scheduler():
    def make(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(0.1, T_max=20),
                                warmup_steps=3, start_lr=0.0, end_lr=0.1)
    j, t = make(jlr), make(tlr)
    for s in (j, t):
        for _ in range(8):
            s.step()
    state = t.state_dict()
    assert state == j.state_dict() and "inner" in state
    fresh = make(tlr)
    fresh.set_state_dict(state)
    assert fresh.inner.last_epoch == t.inner.last_epoch
    _assert_equal(_trajectory(fresh, 10), _trajectory(j, 10))


def test_optimizer_reads_its_scheduler():
    """`get_lr` follows the scheduler; `set_lr` refuses over one, as the
    reference's does; `set_lr_scheduler` swaps it in."""
    p = torch.nn.Parameter(torch.ones(2))
    jp = paddle.nn.Parameter(np.ones(2, np.float32))
    t_sched = tlr.StepDecay(0.1, step_size=1, gamma=0.1)
    j_sched = jlr.StepDecay(0.1, step_size=1, gamma=0.1)
    topt = AdamW(learning_rate=t_sched, parameters=[p])
    jopt = paddle.optimizer.AdamW(learning_rate=j_sched, parameters=[jp])
    for _ in range(3):
        assert topt.get_lr() == jopt.get_lr()
        t_sched.step()
        j_sched.step()
    assert math.isclose(topt.get_lr(), 1e-4, rel_tol=1e-12)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        topt.set_lr(0.5)
    topt2 = AdamW(learning_rate=0.01, parameters=[p])
    topt2.set_lr(0.02)
    assert topt2.get_lr() == 0.02
    topt2.set_lr_scheduler(tlr.ExponentialDecay(0.3, gamma=0.5))
    assert topt2.get_lr() == 0.3
    with pytest.raises(TypeError, match="LRScheduler"):
        topt2.set_lr_scheduler(lambda: 0.1)
