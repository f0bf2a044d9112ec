"""Port parity: float16 training, vs the JAX package.

A tiny GPT (2 layers, hidden 64, 4 heads of 16; tests/test_torch_train.py
`_pair`) from one seed on both sides:

  * O1 float16 (`auto_cast(level="O1", dtype="float16")` over fp32
    weights) and O2 float16 (`decorate` to float16, AdamW with fp32
    masters) in an eager loop under `GradScaler` (init 2^15, grow after 1
    good step, shrink after 1 bad one), an inf injected at step 3: the
    reference's eager backward fails under amp (ROADMAP.md Queue 3), so
    each step's gradients are the port's, handed to both sides, and the
    JAX `GradScaler` and optimizer take them as the port's do. After
    every update (scale, good, bad) equals the JAX scaler's, step by step,
    through the injected inf and through the overflow the growing scale
    reaches on its own (the scaled f16 gradients pass 65504); the losses
    (the JAX side's own forward under the same policy, on its own
    parameters) stay within 2.5e-4 of the port's
    (tests/test_torch_amp.py LOSS_ATOL for float16), and the parameters
    within one f16 step (O2) or 1e-5 (O1, fp32 weights);
  * O2 float16 through both packages' `TrainStep` (a jitted step on the
    JAX side): the loss trajectories within 2.5e-4, falling;
  * a plain float16 model (no amp) with the fused cross-entropy (the CE
    twin on f16 logits) through `TrainStep`: losses within two f16 steps
    at 8-16 (2^-6) of the JAX f16 model's `TrainStep`, whose plain
    cross-entropy returns its loss in f16 (one step, 2^-7, of rounding)
    where the fused one keeps it in fp32.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.amp  # noqa: F401
from paddle_tpu.framework import flags as jflags
from paddle_tpu.incubate.models import \
    GPTPretrainingCriterion as JGPTPretrainingCriterion
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.jit import TrainStep as JTrainStep

from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework import set_flags
from paddle_tpu_torch.incubate.models import (GPTConfig, GPTForCausalLM,
                                              GPTPretrainingCriterion)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import cross_entropy as tce
from paddle_tpu_torch.optimizer import AdamW

from test_torch_amp import _run
from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import _batch, _cfg, _jax_params, _pair

LOSS_ATOL = 2.5e-4
SCALER_KW = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=1,
                 decr_every_n_nan_or_inf=1)
INF_STEP = 3
STEPS = 12


@pytest.fixture(autouse=True)
def reference_flags_at_defaults():
    """The JAX package's flags at their defaults during each test: an
    earlier test in the process may leave one set (the fused numerics
    guardian, say, under which a skipped update still advances the
    optimizer), and these tests hold the port to the reference's default
    semantics."""
    saved = dict(jflags._FLAGS)
    jflags.set_flags({name: default
                      for name, (default, _) in jflags._DEFS.items()})
    yield
    jflags.set_flags(saved)


def _linear(tm):
    return {f"{n}.weight" for n, m in tm.named_modules()
            if isinstance(m, torch.nn.Linear)}


def _hand_grads(jm, tm):
    """The port's gradients onto the JAX parameters, in the JAX layout
    (Linear weights transposed) and dtype, as copies: on the CPU
    `jnp.asarray` of a numpy view aliases the torch gradient's memory and
    JAX reads it when its asynchronous computation runs, which can be
    after the port's scaler has unscaled that gradient in place (or
    `clear_grad` has freed it) on a loaded machine."""
    linear = _linear(tm)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    for n, jp in jm.named_parameters():
        g = np.array(grads[n].detach().float().numpy(), copy=True)
        g = g.T if n in linear else g
        jp.grad = paddle.Tensor(jnp.asarray(g).astype(jp._value.dtype))


def _state(scaler):
    s = scaler.state_dict()
    return (float(s["scale"]), int(s["good_steps"]), int(s["bad_steps"]))


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_f16_scaler_transitions_match_jax(level):
    jm, tm = _pair(128, 4)
    if level == "O2":
        paddle.amp.decorate(jm, level="O2", dtype="float16")
        amp.decorate(tm, level="O2", dtype="float16")
        assert all(p.dtype == torch.float16 for p in tm.parameters())
    jopt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                  parameters=jm.parameters(),
                                  multi_precision=True)
    topt = AdamW(learning_rate=1e-4, parameters=tm.parameters(),
                 multi_precision=True)
    jscaler = paddle.amp.GradScaler(**SCALER_KW)
    tscaler = amp.GradScaler(**SCALER_KW)
    ids, labels = _batch(128, seed=41)
    jcrit, tcrit = JGPTPretrainingCriterion(), GPTPretrainingCriterion()
    t_seq, j_seq, natural = [], [], 0
    for step in range(1, STEPS + 1):
        with paddle.amp.auto_cast(level=level, dtype="float16"):
            jloss = float(jcrit(jm(paddle.to_tensor(ids)),
                                paddle.to_tensor(labels)))
        with amp.auto_cast(level=level, dtype="float16"):
            tloss = tcrit(tm(torch.from_numpy(ids)), torch.from_numpy(labels))
        assert abs(float(tloss) - jloss) <= LOSS_ATOL, (step, tloss, jloss)
        tscaler.scale(tloss).backward()
        if step == INF_STEP:
            list(tm.parameters())[2].grad.view(-1)[0] = float("inf")
        finite = all(bool(torch.isfinite(p.grad).all())
                     for p in tm.parameters())
        natural += int(not finite and step != INF_STEP)
        _hand_grads(jm, tm)
        jscaler.step(jopt)
        jscaler.update()
        tscaler.step(topt)
        tscaler.update()
        jopt.clear_grad()
        topt.clear_grad()
        t_seq.append(_state(tscaler))
        j_seq.append(_state(jscaler))
        assert t_seq[-1] == j_seq[-1], (step, t_seq, j_seq)
    scales = [s for s, _, _ in t_seq]
    assert natural > 0, t_seq            # the growing scale overflowed
    assert scales[INF_STEP - 1] < scales[INF_STEP - 2]
    assert topt._step_count == jopt._step_count
    want = _jax_params(jm, tm)
    for name, p in tm.named_parameters():
        if level == "O2":
            assert topt._accumulators["master_weight"][p].dtype == \
                torch.float32
            np.testing.assert_allclose(p.detach().float().numpy(),
                                       want[name].astype(np.float32),
                                       rtol=2 ** -10, atol=2 ** -14,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=0, atol=1e-5, err_msg=name)


def test_o2_f16_train_step_trajectory_matches_jax():
    (_, j_losses, _), (tm, t_losses, _) = _run("O2", "float16", 10)
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=LOSS_ATOL)
    assert t_losses[-1] < t_losses[0] - 0.5
    assert all(p.dtype == torch.float16 for p in tm.parameters())


def test_plain_f16_model_with_fused_ce_matches_jax(monkeypatch):
    """A float16 model without amp, the fused cross-entropy on (vocabulary
    8192, the kernels' minimum), through TrainStep: every loss goes
    through the CE twin on f16 logits and stays within 2^-6 of the JAX
    f16 model's (whose loss is rounded to f16)."""
    vocab = 8192
    paddle.seed(0)
    jm = JGPTForCausalLM(JGPTConfig(**_cfg(vocab, 4)))
    tm = GPTForCausalLM(GPTConfig(**_cfg(vocab, 4)), device="cpu")
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    jm.half()
    tm.to(torch.float16)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  multi_precision=True)
    topt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                 multi_precision=True)
    jcrit = JGPTPretrainingCriterion()
    jstep = JTrainStep(jm, lambda o, y: jcrit(o, y), jopt)
    tstep = TrainStep(tm, GPTPretrainingCriterion(), topt)
    calls = []
    fwd = tce.cross_entropy_fwd
    monkeypatch.setattr(tce, "cross_entropy_fwd",
                        lambda logits, labels: calls.append(logits.dtype)
                        or fwd(logits, labels))
    ids, labels = _batch(vocab, seed=43)
    set_flags({"FLAGS_use_fused_cross_entropy": True})
    try:
        t_losses = [float(tstep(torch.from_numpy(ids),
                                torch.from_numpy(labels)))
                    for _ in range(5)]
    finally:
        set_flags({"FLAGS_use_fused_cross_entropy": False})
    j_losses = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels)))
                for _ in range(5)]
    assert calls and set(calls) == {torch.float16}
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=2.0 ** -6)
    assert t_losses[-1] < t_losses[0]
