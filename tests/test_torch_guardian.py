"""Port parity: the numeric guard (``FLAGS_check_numerics``) against the JAX
package's eager loop with the flag on and ``FLAGS_eager_step_fusion`` off.

- The skip-step of every optimizer class, through a NaN batch and through
  the lr-spike loop of the reference's ``tests/test_guardian.py``
  (`_spike_run`): each skipped step leaves the parameter and every
  accumulator as they were, bit for bit, on each side; the two
  trajectories agree within ``test_torch_optimizers.OPTIMIZERS[name][1]``
  (AdamW: Adam's); the step counts and the step-level counters of
  `guardian_stats()` are the reference's. The counters of per-op checks
  (``checks_enqueued``, ``flushes``, ``nonfinite_outputs``) count aten ops
  on the port and Paddle ops on the reference, so only whether a
  non-finite output was found is compared.
- `GradScaler` under the guard: the skipped step, the backoff and the
  counters are the reference's, and a forward inf on the scaler's thread
  never raises (the reference's `test_scaler_thread_never_raises_on_
  forward_inf`).
- `TrainStep` on the CPU under ``FLAGS_check_numerics`` (held to the JAX
  eager loop with the flag on) and under ``FLAGS_check_nan_inf`` (the
  port's and the JAX `TrainStep`: both raise and keep the parameters; the
  JAX one lands the step's accumulators, a reference fault in ROADMAP.md
  Queue 3, the port keeps them).

The JAX flags are set to their defaults around each test, and the port's
four check flags cleared.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework import flags as jflags
from paddle_tpu.incubate.models import \
    GPTPretrainingCriterion as JGPTPretrainingCriterion
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.ops import guardian as jguardian

from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import set_flags
from paddle_tpu_torch.incubate.models import GPTPretrainingCriterion
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.ops import guardian, numerics

from test_torch_optimizers import OPTIMIZERS
from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import _batch, _jax_params, _pair

CHECK_FLAGS = {"FLAGS_check_numerics": False,
               "FLAGS_check_numerics_level": 0,
               "FLAGS_check_nan_inf": False,
               "FLAGS_check_nan_inf_level": 0}
# the step-level counters, equal on both sides
STEP_KEYS = ("steps_guarded", "steps_skipped", "scaler_backoffs",
             "faults_injected")
# one configuration of each optimizer class (AdamW's beside
# test_torch_optimizers.py's, with Adam's tolerance)
CASES = {name: OPTIMIZERS[name] for name in (
    "sgd", "momentum", "lamb", "rmsprop_centered", "adagrad", "adadelta",
    "adamax", "lars", "adam_l2")}
CASES["adamw"] = (lambda m: dict(cls=m.AdamW, learning_rate=1e-4,
                                 weight_decay=0.01), 1e-5)
# the lr of the spike loop's spike: the reference's 3e38 overflows the new
# state of every class but three, whose step at that lr stays finite (a
# parameter near -3e38 that the next forward overflows): Adadelta's step
# is ~1e-3 lr here, Lamb's and Lars' are scaled by a ratio of norms. An
# lr of inf overflows theirs.
SPIKE_LR = {"adadelta": float("inf"), "lamb": float("inf"),
            "lars": float("inf")}


def _both(flags):
    jflags.set_flags(flags)
    set_flags(flags)


def _reset():
    set_flags(CHECK_FLAGS)
    for g in (guardian, jguardian):
        g.reset_guardian_stats()
        g.reset_thread_state()


@pytest.fixture(autouse=True)
def reference_flags_at_defaults():
    saved = dict(jflags._FLAGS)
    jflags.set_flags({name: default
                      for name, (default, _) in jflags._DEFS.items()})
    jflags.set_flags({"FLAGS_eager_step_fusion": False})
    _reset()
    yield
    _reset()
    jflags.set_flags(saved)


def _make(name, mod, params, **extra):
    kw = dict(CASES[name][0](mod), **extra)
    return kw.pop("cls")(parameters=params, **kw)


class _Side:
    """One framework's tiny problem: a parameter w [8, 8], its optimizer
    and a step on a batch x [4, 8]."""

    def __init__(self, jax, name, w0, **extra):
        self.jax = jax
        if jax:
            self.w = paddle.to_tensor(w0, stop_gradient=False)
            self.opt = _make(name, paddle.optimizer, [self.w], **extra)
        else:
            self.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
            self.opt = _make(name, topt, [self.w], **extra)

    def loss(self, x, gelu=True):
        if self.jax:
            y = paddle.matmul(paddle.to_tensor(x), self.w)
            return JF.gelu(y).sum() if gelu else y.sum()
        y = torch.from_numpy(x) @ self.w
        return torch.nn.functional.gelu(y).sum() if gelu else y.sum()

    def step(self, x, lr=None, gelu=True, scaler=None):
        if lr is not None:
            self.opt.set_lr(lr)
        loss = self.loss(x, gelu)
        if scaler is None:
            loss.backward()
            self.opt.step()
        else:
            scaler.scale(loss).backward()
            scaler.step(self.opt)
            scaler.update()
        self.opt.clear_grad()

    def state(self):
        """w and every accumulator, as numpy arrays."""
        if self.jax:
            return [np.asarray(self.w._value).copy()] + [
                np.asarray(v).copy() for _, slot in
                sorted(self.opt._accumulators.items())
                for v in slot.values()]
        return [self.w.detach().numpy().copy()] + [
            v.detach().numpy().copy() for _, slot in
            sorted(self.opt._accumulators.items())
            for v in slot.values()]

    def w_np(self):
        return np.asarray(self.w._value) if self.jax \
            else self.w.detach().numpy()

    def guardian(self):
        return jguardian if self.jax else guardian


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y, equal_nan=True)
                                    for x, y in zip(a, b))


def _run(name, batches, lrs=None, gelu=True, level=1, seed=6):
    """Both sides through `batches` under the guard; returns the sides
    and each side's state before each step."""
    rng = np.random.default_rng(seed)
    w0 = rng.standard_normal((8, 8)).astype(np.float32)
    _both({"FLAGS_check_numerics": True,
           "FLAGS_check_numerics_level": level})
    sides = [_Side(True, name, w0), _Side(False, name, w0)]
    before = {0: [], 1: []}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, x in enumerate(batches):
            for k, side in enumerate(sides):
                before[k].append(side.state())
                side.step(x, None if lrs is None else lrs[i], gelu)
        for k, side in enumerate(sides):
            before[k].append(side.state())
            side.guardian().flush()
    return sides, before


def _assert_parity(name, sides, before, skipped):
    jside, tside = sides
    atol = CASES[name][1]
    for k in (0, 1):
        for i in range(len(before[k]) - 1):
            noop = _same(before[k][i], before[k][i + 1])
            assert noop == (i in skipped), (name, k, i)
    np.testing.assert_allclose(tside.w_np(), jside.w_np(), rtol=0,
                               atol=atol)
    assert tside.opt._step_count == jside.opt._step_count
    t_stats, j_stats = guardian.guardian_stats(), jguardian.guardian_stats()
    assert {k: t_stats[k] for k in STEP_KEYS} == \
        {k: j_stats[k] for k in STEP_KEYS}, (t_stats, j_stats)
    assert t_stats["steps_skipped"] == len(skipped)
    assert (t_stats["nonfinite_outputs"] > 0) == \
        (j_stats["nonfinite_outputs"] > 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_nan_batch_skip_step_matches_jax(name):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    nan = np.full((4, 8), np.nan, np.float32)
    sides, before = _run(name, [x, x, nan, x, x])
    _assert_parity(name, sides, before, skipped={2})
    assert guardian.guardian_stats()["nonfinite_outputs"] > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_lr_spike_skip_step_matches_jax(name):
    """The reference's spike loop: finite gradients, one step's lr
    overflowing the new state, level 0 (nothing in the forward is
    non-finite, so nothing raises)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 8)) * 10).astype(np.float32)
    spike = SPIKE_LR.get(name, 3e38)
    lrs = [spike if i == 9 else 1e-3 for i in range(12)]
    sides, before = _run(name, [x] * 12, lrs, gelu=False, level=0, seed=3)
    j_skipped = {i for i in range(12)
                 if _same(before[0][i], before[0][i + 1])}
    assert 9 in j_skipped
    _assert_parity(name, sides, before, skipped=j_skipped)


def test_guard_off_updates_like_before():
    """With the flag off a NaN batch poisons the parameter on both sides
    and nothing is counted."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    w0 = rng.standard_normal((8, 8)).astype(np.float32)
    side = _Side(False, "momentum", w0)
    side.step(x)
    side.step(np.full((4, 8), np.nan, np.float32))
    assert np.isnan(side.w_np()).all()
    assert guardian.guardian_stats() == {k: 0 for k in
                                         guardian.guardian_stats()}


def test_grad_scaler_under_the_guard_matches_jax():
    """The reference's scaler-thread loop: a NaN batch under a GradScaler
    skips the step, backs the scale off, and the flush does not raise on
    the non-finite forward (the scaler's thread), on both sides."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    w0 = rng.standard_normal((8, 8)).astype(np.float32)
    nan = np.full((4, 8), np.nan, np.float32)
    _both({"FLAGS_check_numerics": True})
    sides = [_Side(True, "momentum", w0), _Side(False, "momentum", w0)]
    scalers = [paddle.amp.GradScaler(init_loss_scaling=64.0,
                                     decr_every_n_nan_or_inf=1),
               amp.GradScaler(init_loss_scaling=64.0,
                              decr_every_n_nan_or_inf=1)]
    states = []
    for side, scaler in zip(sides, scalers):
        side.step(x, scaler=scaler)
        good = side.state()
        side.step(nan, scaler=scaler)
        side.guardian().flush()          # must not raise
        assert _same(good, side.state())
        side.step(x, scaler=scaler)
        side.guardian().flush()
        states.append(scaler.state_dict())
    assert states[0] == states[1] and states[1]["scale"] == 32.0
    np.testing.assert_allclose(sides[1].w_np(), sides[0].w_np(), rtol=0,
                               atol=CASES["momentum"][1])
    assert sides[1].opt._step_count == sides[0].opt._step_count == 3
    t_stats, j_stats = guardian.guardian_stats(), jguardian.guardian_stats()
    assert {k: t_stats[k] for k in STEP_KEYS} == \
        {k: j_stats[k] for k in STEP_KEYS}
    assert t_stats["steps_skipped"] == 1
    assert t_stats["scaler_backoffs"] == 1


def test_grad_scaler_step_reads_nothing_under_the_guard(monkeypatch):
    """Under the guard `GradScaler.step` reads no tensor on the host (the
    boundary's resolve left out: on the CPU it reads its scalars at once);
    with the guard off it reads found-inf, once."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    w0 = rng.standard_normal((8, 8)).astype(np.float32)
    reads = []
    orig = torch.Tensor.__bool__

    def counting(self):
        reads.append(self.dtype)
        return orig(self)

    monkeypatch.setattr(guardian, "maybe_flush", lambda: None)
    for flag, want in ((True, 0), (False, 1)):
        set_flags({"FLAGS_check_numerics": flag})
        side = _Side(False, "sgd", w0)
        scaler = amp.GradScaler(init_loss_scaling=8.0)
        loss = side.loss(x)
        scaler.scale(loss).backward()
        reads.clear()
        monkeypatch.setattr(torch.Tensor, "__bool__", counting)
        scaler.step(side.opt)
        scaler.update()
        monkeypatch.setattr(torch.Tensor, "__bool__", orig)
        assert len(reads) == want, (flag, reads)


# -- TrainStep ---------------------------------------------------------------

def _gpt_runs(steps, poison, level=1):
    """The tiny GPT pair from one seed with AdamW: the JAX eager loop and
    the port's TrainStep (eager on the CPU), the loss multiplied by a
    factor that is NaN at the steps in `poison`; returns both sides'
    losses and parameters before each step."""
    jm, tm = _pair(128, 4)
    ids, labels = _batch(128, seed=5)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    t_opt = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    jcrit, tcrit = JGPTPretrainingCriterion(), GPTPretrainingCriterion()
    factor = [1.0]
    tstep = TrainStep(tm, lambda out, y: tcrit(out, y) * factor[0], t_opt)
    _both({"FLAGS_check_numerics": True,
           "FLAGS_check_numerics_level": level})
    j_losses, t_losses, j_before, t_before = [], [], [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(steps):
            factor[0] = float("nan") if i in poison else 1.0
            j_before.append([np.asarray(p._value).copy()
                             for p in jm.parameters()])
            t_before.append([p.detach().numpy().copy()
                             for p in tm.parameters()])
            loss = jcrit(jm(paddle.to_tensor(ids)),
                         paddle.to_tensor(labels)) * factor[0]
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            j_losses.append(float(loss))
            t_losses.append(float(tstep(torch.from_numpy(ids),
                                        torch.from_numpy(labels))))
        jguardian.flush()
        guardian.flush()
    return (jm, jopt, j_losses, j_before), (tm, t_opt, t_losses, t_before)


def test_train_step_under_check_numerics_matches_jax_eager():
    (jm, jopt, jl, jb), (tm, t_opt, tl, tb) = _gpt_runs(5, poison={2})
    finite = [i for i in range(5) if i != 2]
    np.testing.assert_allclose([tl[i] for i in finite],
                               [jl[i] for i in finite], rtol=1e-5,
                               atol=1e-5)
    assert np.isnan(tl[2]) and np.isnan(jl[2])
    for before in (jb, tb):
        assert _same(before[2], before[3])          # the skipped step
        assert not _same(before[3], before[4])      # and the next one ran
    want = _jax_params(jm, tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-5, err_msg=name)
    assert t_opt._step_count == jopt._step_count == 5
    t_stats, j_stats = guardian.guardian_stats(), jguardian.guardian_stats()
    assert t_stats["steps_skipped"] == j_stats["steps_skipped"] == 1
    assert t_stats["steps_guarded"] == j_stats["steps_guarded"] == 5
    assert t_stats["nonfinite_outputs"] >= 1


def test_train_step_nonfinite_loss_raises_at_level0():
    """At level 0 a NaN loss raises at a boundary on both sides: the JAX
    eager loop names the op, the port's TrainStep its step."""
    with pytest.raises(FloatingPointError, match="non-finite"):
        _gpt_runs(3, poison={1}, level=0)
    jguardian.reset_thread_state()
    _, tm = _pair(128, 4)
    ids, labels = _batch(128, seed=5)
    crit = GPTPretrainingCriterion()
    factor = [1.0]
    step = TrainStep(tm, lambda out, y: crit(out, y) * factor[0],
                     topt.AdamW(learning_rate=1e-3,
                                parameters=tm.parameters()))
    set_flags({"FLAGS_check_numerics": True})
    step(torch.from_numpy(ids), torch.from_numpy(labels))
    factor[0] = float("nan")
    with pytest.raises(FloatingPointError, match="'train_step'.*step 2"):
        step(torch.from_numpy(ids), torch.from_numpy(labels))
        guardian.flush()


def test_train_step_under_check_nan_inf_keeps_state_jax_lands_slots():
    """Both TrainSteps raise on a NaN loss (a NaN put into the final
    LayerNorm's weight on both sides) and keep the parameters; the JAX one
    lands that step's accumulators (its buffers were donated; a reference
    fault, ROADMAP.md Queue 3), the port keeps them too."""
    jm, tm = _pair(128, 4)
    ids, labels = _batch(128, seed=5)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    t_opt = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    jcrit = JGPTPretrainingCriterion()
    jstep = JTrainStep(jm, lambda out, y: jcrit(out, y), jopt)
    tstep = TrainStep(tm, GPTPretrainingCriterion(), t_opt)
    _both({"FLAGS_check_nan_inf": True})
    args_j = (paddle.to_tensor(ids), paddle.to_tensor(labels))
    args_t = (torch.from_numpy(ids), torch.from_numpy(labels))
    jstep(*args_j)
    tstep(*args_t)
    j_ln = dict(jm.named_parameters())["gpt.ln_f.weight"]
    t_ln = dict(tm.named_parameters())["gpt.ln_f.weight"]
    good = t_ln.detach().clone()
    nan = np.full(tuple(good.shape), np.nan, np.float32)
    j_ln.set_value(nan)
    with torch.no_grad(), numerics.suspended():     # strict mode checks it
        t_ln.copy_(torch.from_numpy(nan))

    def t_state():
        return [p.detach().numpy().copy() for p in tm.parameters()] + [
            v.detach().numpy().copy() for _, slot in
            sorted(t_opt._accumulators.items()) for v in slot.values()]

    j_params = [np.asarray(p._value).copy() for p in jm.parameters()]
    j_slots = [np.asarray(v).copy() for v in
               jopt._accumulators["moment1"].values()]
    before = t_state()
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        jstep(*args_j)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        tstep(*args_t)
    assert _same(j_params, [np.asarray(p._value) for p in jm.parameters()])
    assert not _same(j_slots, [np.asarray(v) for v in
                               jopt._accumulators["moment1"].values()])
    assert _same(before, t_state())
    # the port trains on once the loss is finite again
    with torch.no_grad():
        t_ln.copy_(good)
    tstep(*args_t)
    assert not _same(before[:1], t_state()[:1])
