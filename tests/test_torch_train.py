"""Port parity: the training step of paddle_tpu_torch vs the JAX package.

- A 10-step `TrainStep` loss trajectory of a tiny GPT (2 layers, hidden 64)
  under AdamW against the JAX `TrainStep` from the same weights (carried
  with `load_jax_state`) and the same numpy batch, fp32, dropout 0: heads
  4 (the plain attention path) and 1 (head_dim 64, the flash route), with
  ``FLAGS_use_fused_cross_entropy`` off (V = 128) and on (V = 8192, the
  fused route; the JAX package takes its unfused path off the TPU, which
  has the same semantics).
- The same trajectory under a learning-rate schedule
  (`LinearWarmup(CosineAnnealingDecay)`, stepped after every step on both
  sides) against the JAX `TrainStep(donate="all")`; an eager
  `Optimizer.step` after three TrainStep steps, continuing from the same
  accumulators on both sides; the losses a TrainStep returns stay what
  they were.
- One AdamW `_single_update` with ``multi_precision`` on a bf16 parameter.
- An eager `Optimizer.step` with `ClipGradByGlobalNorm`, and each clip
  against the reference's on the same arrays.
- What is not ported raises (the clip inside TrainStep and the
  regularizers now build).

Tolerances, fp32: losses 1e-5 relative and absolute (the same sums in
another order, through 10 steps). Parameters after 10 steps: 1e-5
absolute (8e-7 seen). Adam's step is about lr * sign(m1), so rounding
moves a parameter by far less than the step; only a gradient element
within rounding of 0 could flip sign and move one element by up to
2 * lr = 2e-4 per step, and this seed's batch has none.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.incubate.models import \
    GPTPretrainingCriterion as JGPTPretrainingCriterion
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework import set_flags
from paddle_tpu_torch.incubate.models import (GPTConfig, GPTForCausalLM,
                                              GPTPretrainingCriterion)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as tlr

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

LR = 1e-4
STEPS = 10
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = 1e-5


def _cfg(vocab, heads):
    return dict(vocab_size=vocab, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=heads, intermediate_size=128,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)


def _pair(vocab, heads):
    paddle.seed(0)
    jm = JGPTForCausalLM(JGPTConfig(**_cfg(vocab, heads)))
    tm = GPTForCausalLM(GPTConfig(**_cfg(vocab, heads)), device="cpu")
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    return jm, tm


def _batch(vocab, seed=0, b=2, n=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, n)).astype(np.int64)
    labels = rng.integers(0, vocab, (b, n)).astype(np.int64)
    labels[0, :3] = -100                  # ignored positions
    return ids, labels


def _jax_params(jm, tm):
    """The JAX model's parameters as numpy arrays in the port's layout
    (Linear weights transposed to torch's [out, in])."""
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    return {n: (np.asarray(p._value).T if n in linear
                else np.asarray(p._value))
            for n, p in jm.named_parameters()}


def _decays(name):
    return not (name.endswith(".bias") or ".ln_" in name)


def _adamw_pair(jm, tm, **kw):
    """AdamW on both sides with one decay rule; the JAX side names its
    parameters param_<n>, so its rule is mapped by position."""
    t_names = [n for n, _ in tm.named_parameters()]
    j_names = [p.name for p in jm.parameters()]
    by_jax_name = {j: _decays(t) for j, t in zip(j_names, t_names)}
    jopt = paddle.optimizer.AdamW(
        learning_rate=LR, parameters=jm.parameters(),
        apply_decay_param_fun=lambda n: by_jax_name[n], **kw)
    topt = AdamW(learning_rate=LR, parameters=tm.named_parameters(),
                 apply_decay_param_fun=_decays, **kw)
    return jopt, topt


@pytest.mark.parametrize("heads", [4, 1])
@pytest.mark.parametrize("fused_ce", [False, True])
def test_train_step_trajectory_matches_jax(heads, fused_ce):
    vocab = 8192 if fused_ce else 128
    jm, tm = _pair(vocab, heads)
    jopt, topt = _adamw_pair(jm, tm, weight_decay=0.01)
    jcrit, tcrit = JGPTPretrainingCriterion(), GPTPretrainingCriterion()
    jstep = JTrainStep(jm, lambda o, y: jcrit(o, y), jopt)
    tstep = TrainStep(tm, tcrit, topt)
    ids, labels = _batch(vocab)
    set_flags({"FLAGS_use_fused_cross_entropy": fused_ce})
    try:
        t_losses = [float(tstep(torch.from_numpy(ids),
                                torch.from_numpy(labels)))
                    for _ in range(STEPS)]
    finally:
        set_flags({"FLAGS_use_fused_cross_entropy": False})
    jx, jy = paddle.to_tensor(ids), paddle.to_tensor(labels)
    j_losses = [float(jstep(jx, jy)) for _ in range(STEPS)]
    np.testing.assert_allclose(t_losses, j_losses, **LOSS_TOL)
    assert t_losses[-1] < t_losses[0]
    want = _jax_params(jm, tm)
    for name, tp in tm.named_parameters():
        np.testing.assert_allclose(tp.detach().numpy(), want[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def _schedule(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(LR, T_max=STEPS),
                            warmup_steps=3, start_lr=LR / 10, end_lr=LR)


def _adamw_scheduled(jm, tm):
    """AdamW on both sides, every tensor decaying, lr from the schedule."""
    j_sched, t_sched = _schedule(jlr), _schedule(tlr)
    jopt = paddle.optimizer.AdamW(learning_rate=j_sched,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01)
    topt = AdamW(learning_rate=t_sched, parameters=tm.parameters(),
                 weight_decay=0.01)
    return (jopt, j_sched), (topt, t_sched)


def _assert_params_match(jm, tm):
    want = _jax_params(jm, tm)
    for name, tp in tm.named_parameters():
        np.testing.assert_allclose(tp.detach().numpy(), want[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("heads", [4, 1])
def test_train_step_trajectory_under_a_schedule_matches_jax(heads):
    """lr changes at every step; the JAX side donates everything, as the
    reference's benchmark step does."""
    jm, tm = _pair(128, heads)
    (jopt, j_sched), (topt, t_sched) = _adamw_scheduled(jm, tm)
    jcrit, tcrit = JGPTPretrainingCriterion(), GPTPretrainingCriterion()
    jstep = JTrainStep(jm, lambda o, y: jcrit(o, y), jopt, donate="all")
    tstep = TrainStep(tm, tcrit, topt)
    ids, labels = _batch(128, seed=3)
    jx, jy = paddle.to_tensor(ids), paddle.to_tensor(labels)
    t_losses, j_losses, lrs = [], [], []
    for _ in range(STEPS):
        lrs.append(topt.get_lr())
        assert lrs[-1] == jopt.get_lr()
        t_losses.append(float(tstep(torch.from_numpy(ids),
                                    torch.from_numpy(labels))))
        j_losses.append(float(jstep(jx, jy)))
        t_sched.step()
        j_sched.step()
    assert len(set(lrs)) == STEPS
    np.testing.assert_allclose(t_losses, j_losses, **LOSS_TOL)
    assert t_losses[-1] < t_losses[0]
    assert topt._step_count == jopt._step_count == STEPS
    _assert_params_match(jm, tm)


def test_eager_step_after_train_steps_continues_like_jax():
    """Three TrainStep steps, then loss.backward() and an eager
    Optimizer.step(): the eager update starts from the accumulators (and
    step count) the TrainStep left, on both sides."""
    jm, tm = _pair(128, 4)
    (jopt, _), (topt, _) = _adamw_scheduled(jm, tm)
    jcrit, tcrit = JGPTPretrainingCriterion(), GPTPretrainingCriterion()
    jstep = JTrainStep(jm, lambda o, y: jcrit(o, y), jopt)
    tstep = TrainStep(tm, tcrit, topt)
    ids, labels = _batch(128, seed=4)
    jx, jy = paddle.to_tensor(ids), paddle.to_tensor(labels)
    tx, ty = torch.from_numpy(ids), torch.from_numpy(labels)
    for _ in range(3):
        tstep(tx, ty)
        jstep(jx, jy)
    moments = {id(p): topt._accumulators["moment1"][p]
               for p in tm.parameters()}
    jloss = jcrit(jm(jx), jy)
    jloss.backward()
    jopt.step()
    tloss = tcrit(tm(tx), ty)
    tloss.backward()
    topt.step()
    topt.clear_grad()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **LOSS_TOL)
    assert topt._step_count == jopt._step_count == 4
    _assert_params_match(jm, tm)
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for (name, tp), jp in zip(tm.named_parameters(), jm.parameters()):
        # updated in place: the TrainStep's moment tensors carried on
        assert topt._accumulators["moment1"][tp] is moments[id(tp)]
        # the moments average gradients that the two packages sum in
        # another order (the losses' 1e-5): each is held to 1e-5 of its
        # tensor's largest entry, since an element near 0 is a
        # cancellation of such gradients
        for acc in ("moment1", "moment2"):
            want = np.asarray(jopt._accumulators[acc][jp.name])
            want = want.T if name in linear else want
            np.testing.assert_allclose(
                topt._accumulators[acc][tp].numpy(), want, rtol=1e-5,
                atol=1e-5 * float(np.abs(want).max()),
                err_msg=f"{name} {acc}")


def test_train_step_returns_a_fresh_loss_each_call():
    """Each call's loss is its own tensor and keeps its value after the
    next call (on the card the graph's static loss is overwritten by every
    replay, so the step returns a clone)."""
    _, tm = _pair(128, 4)
    tstep = TrainStep(tm, GPTPretrainingCriterion(),
                      AdamW(learning_rate=1e-3, parameters=tm.parameters()))
    ids, labels = _batch(128, seed=5)
    x, y = torch.from_numpy(ids), torch.from_numpy(labels)
    first = tstep(x, y)
    value = float(first)
    second = tstep(x, y)
    assert first is not second
    assert first.data_ptr() != second.data_ptr()
    assert float(first) == value != float(second)
    assert not first.requires_grad and first.shape == ()


def test_adamw_single_update_multi_precision_bf16():
    """One update of a bf16 parameter with its fp32 master at step 3,
    the same numpy arrays on both sides: master and moments in fp32, the
    parameter written back as the master cast to bf16."""
    rng = np.random.default_rng(5)
    shape = (8, 16)
    master = rng.standard_normal(shape).astype(np.float32)
    grad = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    m1 = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    m2 = (rng.random(shape) * 1e-5).astype(np.float32)
    kw = dict(learning_rate=1e-3, weight_decay=0.1, multi_precision=True)
    jm, tm = _pair(128, 4)
    jopt = paddle.optimizer.AdamW(parameters=jm.parameters(), **kw)
    topt = AdamW(parameters=tm.parameters(), **kw)
    j_p, j_acc = jopt._single_update(
        jnp.asarray(master).astype(jnp.bfloat16),
        jnp.asarray(grad).astype(jnp.bfloat16),
        {"moment1": jnp.asarray(m1), "moment2": jnp.asarray(m2),
         "master_weight": jnp.asarray(master)},
        jnp.asarray(1e-3, jnp.float32), jnp.asarray(3, jnp.int32))
    t_p, t_acc = topt._single_update(
        torch.from_numpy(master).to(torch.bfloat16),
        torch.from_numpy(grad).to(torch.bfloat16),
        {"moment1": torch.from_numpy(m1), "moment2": torch.from_numpy(m2),
         "master_weight": torch.from_numpy(master)}, 1e-3, 3)
    assert t_p.dtype == torch.bfloat16
    assert sorted(t_acc) == sorted(j_acc) == ["master_weight", "moment1",
                                              "moment2"]
    for name in t_acc:
        assert t_acc[name].dtype == torch.float32
        np.testing.assert_allclose(t_acc[name].numpy(),
                                   np.asarray(j_acc[name]), rtol=1e-6,
                                   atol=1e-9, err_msg=name)
    # the bf16 parameter is the master rounded once: equal, or one bf16
    # step apart where the two fp32 masters straddle a rounding boundary
    np.testing.assert_allclose(t_p.float().numpy(),
                               np.asarray(j_p.astype(jnp.float32)),
                               rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_clips_match_jax(clip):
    rng = np.random.default_rng(6)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((4, 3), (7,), (2, 2, 2))]
    make = {"value": lambda m: m.ClipGradByValue(0.5),
            "norm": lambda m: m.ClipGradByNorm(1.0),
            "global_norm": lambda m: m.ClipGradByGlobalNorm(1.5)}[clip]
    j_out = make(jclip)([(None, paddle.to_tensor(g)) for g in grads])
    t_out = make(tclip)([(None, torch.from_numpy(g)) for g in grads])
    for (_, tg), (_, jg) in zip(t_out, j_out):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg._value),
                                   rtol=1e-6, atol=1e-7)


def test_eager_step_with_global_norm_clip_matches_jax():
    """loss.backward(); opt.step() with ClipGradByGlobalNorm on both sides.
    epsilon = 1e-2 keeps Adam's first step proportional to the gradient,
    so the clip's scale shows in the parameters."""
    jm, tm = _pair(128, 4)
    kw = dict(learning_rate=1e-2, epsilon=1e-2)
    jopt = paddle.optimizer.Adam(parameters=jm.parameters(),
                                 grad_clip=jclip.ClipGradByGlobalNorm(0.05),
                                 **kw)
    topt = Adam(parameters=tm.parameters(),
                grad_clip=tclip.ClipGradByGlobalNorm(0.05), **kw)
    ids, labels = _batch(128, seed=7)
    jloss = JGPTPretrainingCriterion()(jm(paddle.to_tensor(ids)),
                                       paddle.to_tensor(labels))
    jloss.backward()
    jopt.step()
    before = [p.detach().clone() for p in tm.parameters()]
    tloss = GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                                      torch.from_numpy(labels))
    tloss.backward()
    topt.step()
    topt.clear_grad()
    assert all(p.grad is None for p in tm.parameters())
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **LOSS_TOL)
    want = _jax_params(jm, tm)
    moved = 0.0
    for (name, tp), b in zip(tm.named_parameters(), before):
        np.testing.assert_allclose(tp.detach().numpy(), want[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        moved = max(moved, float((tp.detach() - b).abs().max()))
    assert moved > 0


def test_not_ported_options_raise():
    """What still raises. A TrainStep over an optimizer with a clip and a
    float ``weight_decay`` (L2Decay) raised until they were ported; both
    now build (`tests/test_torch_optimizers.py` holds them to the
    reference)."""
    _, tm = _pair(128, 4)
    TrainStep(tm, GPTPretrainingCriterion(),
              AdamW(parameters=tm.parameters(),
                    grad_clip=tclip.ClipGradByGlobalNorm(1.0)))
    assert Adam(parameters=tm.parameters(),
                weight_decay=0.01).regularization.coeff == 0.01
    # amp takes bf16 and float16 only
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        amp.auto_cast(dtype="int8")
    # a schedule must be an LRScheduler (ported); any other callable is
    # refused when the optimizer is made
    with pytest.raises(TypeError, match="LRScheduler"):
        AdamW(learning_rate=lambda step: 1e-3, parameters=tm.parameters())
    with pytest.raises(ValueError, match="named_parameters"):
        AdamW(parameters=tm.parameters(), apply_decay_param_fun=_decays)
    with pytest.raises(ValueError, match="parameters"):
        AdamW()


def test_num_params_and_flops_per_token_match_jax():
    jm, tm = _pair(128, 4)
    assert tm.num_params() == jm.num_params()
    assert tm.num_params(include_embeddings=False) == \
        jm.num_params(include_embeddings=False)
    for training in (True, False):
        assert tm.flops_per_token(16, training) == \
            jm.flops_per_token(16, training)
