"""Port parity: `amp` (`auto_cast` O1/O2, `decorate`, `GradScaler`)
against the JAX package.

- The cast record: one forward and backward of a tiny GPT (2 layers,
  hidden 64) under O1 and under O2 (bf16; O1 also float16), recorded on
  each side as the sequence of white- or black-listed op names with their
  input dtypes (as the op was called, before its casts): on the reference
  side from `amp_cast_inputs` (wrapped) inside the JAX `TrainStep`'s
  trace, on the port's from its two hooks (`amp.record_casts`). The two
  sequences are identical.
- O1 loss trajectories in bf16 and in float16, and O2 (`decorate` +
  AdamW(multi_precision)) in bf16, through `TrainStep` on both sides.
  Tolerances: the loss is a mean over 30 rows of logsumexp over low
  precision logits, with every matmul output rounded to the amp dtype on
  both sides but summed in another order and, on the reference side, kept
  in fp32 where XLA fuses across an op; bf16 carries 8 bits, so 2e-3
  absolute (7.4e-4 seen), float16 carries 11, so 2.5e-4 (8.5e-5 seen).
  The losses must fall.
- `GradScaler`: the (scale, good, bad) triple after every update equals
  the reference's, step by step, through injected infs and NaNs; a step
  with a non-finite gradient leaves parameters and accumulators bit for
  bit as they were; between the two runs the parameters stay within 1e-5
  (fp32 Adam, lr 1e-4, as `test_torch_train.py`).
- The reference's own eager backward under O1 fails on the first cast
  (ROADMAP.md Queue 3); the port's does not.
"""
from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp  # noqa: F401
from paddle_tpu.incubate.models import \
    GPTPretrainingCriterion as JGPTPretrainingCriterion
from paddle_tpu.jit import TrainStep as JTrainStep

from paddle_tpu_torch import amp
from paddle_tpu_torch.incubate.models import GPTPretrainingCriterion
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import Adam, AdamW

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import _batch, _jax_params, _pair

_JAC = sys.modules["paddle_tpu.amp.auto_cast"]
LISTED = amp.WHITE_LIST | amp.BLACK_LIST
LOSS_ATOL = {"bfloat16": 2e-3, "float16": 2.5e-4}


def _jax_record(monkeypatch):
    """Record the reference's listed ops: `amp_cast_inputs` wrapped."""
    record, orig = [], _JAC.amp_cast_inputs

    def wrapped(op_name, tensors):
        st = _JAC.current_amp_state()
        if st is not None and st.enabled and op_name in LISTED:
            record.append((op_name, tuple(
                str(np.dtype(getattr(t, "_value", t).dtype))
                for t in tensors)))
        return orig(op_name, tensors)

    monkeypatch.setattr(_JAC, "amp_cast_inputs", wrapped)
    return record


def _models(level, dtype, heads=4):
    jm, tm = _pair(128, heads)
    if level == "O2":
        paddle.amp.decorate(jm, level="O2", dtype=dtype)
        amp.decorate(tm, level="O2", dtype=dtype)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  multi_precision=True)
    topt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                 multi_precision=True)
    jcrit = JGPTPretrainingCriterion()
    jstep = JTrainStep(jm, lambda o, y: jcrit(o, y), jopt)
    tstep = TrainStep(tm, GPTPretrainingCriterion(), topt)
    return (jm, jstep), (tm, tstep)


def _run(level, dtype, steps, monkeypatch=None, heads=4):
    (jm, jstep), (tm, tstep) = _models(level, dtype, heads)
    ids, labels = _batch(128, seed=31)
    j_record = _jax_record(monkeypatch) if monkeypatch else None
    with paddle.amp.auto_cast(level=level, dtype=dtype):
        j_losses = [float(jstep(paddle.to_tensor(ids),
                                paddle.to_tensor(labels)))
                    for _ in range(steps)]
    with amp.record_casts() as t_record, \
            amp.auto_cast(level=level, dtype=dtype):
        t_losses = [float(tstep(torch.from_numpy(ids),
                                torch.from_numpy(labels)))
                    for _ in range(steps)]
    t_record = [r for r in t_record if r[0] in LISTED]
    return (jm, j_losses, j_record), (tm, t_losses, t_record)


@pytest.mark.parametrize("level,dtype", [("O1", "bfloat16"),
                                         ("O2", "bfloat16"),
                                         ("O1", "float16")])
def test_cast_record_matches_jax(level, dtype, monkeypatch):
    (_, _, j_rec), (_, _, t_rec) = _run(level, dtype, 1, monkeypatch)
    assert t_rec == j_rec
    names = [name for name, _ in t_rec]
    # 2 layers: 2 LayerNorms and 4 Linears a block, ln_f, the LM head,
    # the loss
    assert names.count("linear") == 9 and names.count("layer_norm") == 5
    assert t_rec[-1] == ("cross_entropy", (dtype, "int64"))
    low = {"bfloat16", "float16"}
    if level == "O1":
        # the residual stream stays fp32, each projection's output is low
        assert t_rec[0] == ("layer_norm", ("float32",) * 3)
        assert t_rec[2] == ("linear", (dtype, "float32", "float32"))
    else:
        assert t_rec[0] == ("layer_norm", (dtype,) * 3)
        assert all(set(d[1:]) <= low for n, d in t_rec if n == "linear")


@pytest.mark.parametrize("level,dtype,heads", [("O1", "bfloat16", 4),
                                               ("O1", "bfloat16", 1),
                                               ("O1", "float16", 4),
                                               ("O2", "bfloat16", 4)])
def test_loss_trajectory_matches_jax(level, dtype, heads):
    (_, j_losses, _), (tm, t_losses, _) = _run(level, dtype, 10,
                                               heads=heads)
    np.testing.assert_allclose(t_losses, j_losses, rtol=0,
                               atol=LOSS_ATOL[dtype])
    assert t_losses[-1] < t_losses[0] - 0.5
    if level == "O2":
        assert all(p.dtype == getattr(torch, dtype)
                   for p in tm.parameters())


def test_jax_eager_backward_under_o1_fails_the_port_does_not():
    """The reference's eager O1 cast hands its fp32 cotangent to a bf16
    op's VJP, so ``loss.backward()`` raises; the port's casts are
    autograd ops."""
    jm, tm = _pair(128, 4)
    ids, labels = _batch(128, seed=32)
    with paddle.amp.auto_cast(level="O1"):
        jloss = JGPTPretrainingCriterion()(jm(paddle.to_tensor(ids)),
                                           paddle.to_tensor(labels))
    with pytest.raises(Exception, match="bfloat16"):
        jloss.backward()
    with amp.auto_cast(level="O1"):
        tloss = GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                                          torch.from_numpy(labels))
    tloss.backward()
    assert tloss.dtype == torch.float32
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in tm.parameters())


def test_policy_scopes():
    """Nesting, ``enable=False``, custom lists, `suspended`, and the
    backward pass: each as the reference's policy reads."""
    x = torch.randn(4, 4, requires_grad=True)
    w = torch.randn(4, 4)
    assert (x @ w).dtype == torch.float32
    with amp.auto_cast():
        assert (x @ w).dtype == torch.bfloat16
        assert torch.softmax(x.bfloat16(), -1).dtype == torch.float32
        assert (x + w).dtype == torch.float32       # O1 leaves add alone
        with amp.auto_cast(enable=False):
            assert (x @ w).dtype == torch.float32
        with amp.suspended():
            assert torch.nn.functional.linear(x, w).dtype == torch.float32
        with amp.auto_cast(custom_black_list={"matmul"}):
            assert (x @ w).dtype == torch.float32
        with amp.auto_cast(level="O2"):
            assert (x + w).dtype == torch.bfloat16
            assert x.sum().dtype == torch.float32
        y = (x @ w).float().sum()
    y.backward()
    assert x.grad.dtype == torch.float32
    assert (x @ w).dtype == torch.float32
    with pytest.raises(ValueError, match="O0/O1/O2"):
        amp.auto_cast(level="O3")
    assert amp.amp_guard is amp.auto_cast


def test_decorate_keeps_parameter_identity():
    _, tm = _pair(128, 4)
    params = list(tm.parameters())
    opt = AdamW(parameters=params, multi_precision=True)
    out = amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    assert out == (tm, opt)
    assert [id(p) for p in tm.parameters()] == [id(p) for p in params]
    assert all(p.dtype == torch.bfloat16 for p in params)
    assert amp.decorate(tm, level="O1") is tm


# the (step, parameter index, value) injections: an inf, two bad steps in
# a row (a shrink with decr_every_n_nan_or_inf=2), a NaN after a grow
INJECT = {3: (0, float("inf")), 6: (2, float("nan")),
          7: (5, float("-inf")), 11: (1, float("nan"))}


def test_grad_scaler_sequence_matches_jax():
    """An fp32 eager loop with a GradScaler on each side (the reference's
    eager O1 backward fails, above), infs and NaNs injected into one
    gradient element at `INJECT`'s steps: the scale, good and bad counts
    after each update equal the reference's; the skipped steps move
    nothing, bit for bit; the parameters stay within 1e-5 of the
    reference's."""
    jm, tm = _pair(128, 4)
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    jscaler, tscaler = paddle.amp.GradScaler(**kw), amp.GradScaler(**kw)
    jopt = paddle.optimizer.Adam(learning_rate=1e-4,
                                 parameters=jm.parameters())
    topt = Adam(learning_rate=1e-4, parameters=tm.parameters())
    ids, labels = _batch(128, seed=33)
    jcrit, tcrit = JGPTPretrainingCriterion(), GPTPretrainingCriterion()
    j_seq, t_seq, skipped = [], [], 0
    for step in range(1, 14):
        jloss = jcrit(jm(paddle.to_tensor(ids)), paddle.to_tensor(labels))
        jscaler.scale(jloss).backward()
        tloss = tcrit(tm(torch.from_numpy(ids)), torch.from_numpy(labels))
        tscaler.scale(tloss).backward()
        if step in INJECT:
            i, value = INJECT[step]
            jp = list(jm.parameters())[i]
            g = np.asarray(jp.grad._value).copy()
            g.reshape(-1)[0] = value
            jp.grad._value = paddle.to_tensor(g)._value
            list(tm.parameters())[i].grad.view(-1)[0] = value
        before = [p.detach().clone() for p in tm.parameters()] + [
            t.clone() for slot in topt._accumulators.values()
            for t in slot.values()]
        jscaler.step(jopt)
        jscaler.update()
        tscaler.step(topt)
        tscaler.update()
        jopt.clear_grad()
        topt.clear_grad()
        after = list(tm.parameters()) + [
            t for slot in topt._accumulators.values() for t in slot.values()]
        if step in INJECT:
            skipped += 1
            assert all(torch.equal(a, b) for a, b in zip(before, after))
        j_state = jscaler.state_dict()
        t_seq.append(tuple(tscaler.state_dict()[k]
                           for k in ("scale", "good_steps", "bad_steps")))
        j_seq.append((j_state["scale"], j_state["good_steps"],
                      j_state["bad_steps"]))
    assert t_seq == j_seq
    scales = [s for s, _, _ in t_seq]
    # grows and a shrink both happened
    assert any(b > a for a, b in zip(scales, scales[1:])), t_seq
    assert any(b < a for a, b in zip(scales, scales[1:])), t_seq
    assert topt._step_count == jopt._step_count == 13 - skipped
    want = _jax_params(jm, tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-5, err_msg=name)


def test_grad_scaler_state_dict_round_trip():
    s = amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=1)
    assert s.get_init_loss_scaling() == 8.0
    loss = s.scale(torch.tensor(2.0))
    assert float(loss) == 16.0
    state = s.state_dict()
    fresh = amp.GradScaler()
    fresh.load_state_dict(state)
    assert fresh.state_dict()["scale"] == 8.0
    assert amp.GradScaler(enable=False).scale(loss) is loss
