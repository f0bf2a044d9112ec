"""Port parity: paddle_tpu_torch cross-entropy vs the JAX package.

- The fused function (`kernels.cross_entropy.fused_softmax_cross_entropy`,
  on CPU tensors its plain twins) against the JAX
  `fused_softmax_cross_entropy(..., interpret=True)` at the shape of
  tests/test_fused_kernels.py (R = 70, V = 3000: neither divides the TPU
  blocks), with negative labels.
- `nn.functional.cross_entropy` against the JAX one for ignore_index, the
  three reductions, label smoothing, class weights and soft labels, loss
  and gradient.
- The routing rule (`FLAGS_use_fused_cross_entropy`, V >= 8192, the plain
  options) and the incubate entry point that forces the fused path.

Tolerances, fp32: loss 1e-5 absolute and relative (one logsumexp over
3000 terms, summed in another order); gradient 1e-5 absolute, 1e-4
relative (the reference's own fused-CE test bounds).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.kernels.cross_entropy import (
    fused_softmax_cross_entropy as j_fused)

from paddle_tpu_torch.framework import set_flags
from paddle_tpu_torch.incubate.nn.functional import \
    fused_softmax_cross_entropy as incubate_fused
from paddle_tpu_torch.kernels import cross_entropy as tce
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import loss as tloss

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _logits_labels(r, v, seed, ignore=()):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((r, v)).astype(np.float32)
    labels = rng.integers(0, v, r).astype(np.int32)
    for i in ignore:
        labels[i] = -100
    return logits, labels


@pytest.fixture
def fused_flag():
    set_flags({"FLAGS_use_fused_cross_entropy": True})
    yield
    set_flags({"FLAGS_use_fused_cross_entropy": False})


def test_fused_loss_and_grad_match_pallas_interpret():
    r, v = 70, 3000
    logits, labels = _logits_labels(r, v, seed=0, ignore=(3, 41))
    labels[7] = -1                       # any negative label picks nothing
    w = np.random.default_rng(1).standard_normal(r).astype(np.float32)
    jl, jlab, jw = jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w)
    j_loss = j_fused(jl, jlab, True)
    j_grad = jax.grad(lambda x: jnp.sum(j_fused(x, jlab, True) * jw))(jl)
    tl = torch.from_numpy(logits).requires_grad_(True)
    t_loss = tce.fused_softmax_cross_entropy(tl, torch.from_numpy(labels))
    assert t_loss.dtype == torch.float32 and t_loss.shape == (r,)
    (t_loss * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t_loss.detach().numpy(), np.asarray(j_loss),
                               **LOSS_TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(j_grad),
                               **GRAD_TOL)
    # a negative label's loss is the row's logsumexp
    lse = torch.logsumexp(torch.from_numpy(logits), -1)
    np.testing.assert_allclose(t_loss.detach().numpy()[[3, 7, 41]],
                               lse.numpy()[[3, 7, 41]], **LOSS_TOL)


CASES = {
    "mean_ignore": dict(reduction="mean"),
    "sum_ignore": dict(reduction="sum"),
    "none_ignore": dict(reduction="none"),
    "smoothing": dict(label_smoothing=0.1),
    "weight_mean": dict(weight=True),
    "weight_sum": dict(weight=True, reduction="sum"),
    "soft_label": dict(soft_label=True),
    "soft_label_weight_none": dict(soft_label=True, weight=True,
                                   reduction="none"),
    "labels_r_by_1": dict(column_labels=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cross_entropy_matches_jax(case):
    opts = dict(CASES[case])
    r, c = 12, 10
    logits, labels = _logits_labels(r, c, seed=2, ignore=(1, 5))
    rng = np.random.default_rng(3)
    if opts.pop("soft_label", False):
        raw = rng.random((r, c)).astype(np.float32)
        labels = raw / raw.sum(-1, keepdims=True)
        opts["soft_label"] = True
    if opts.pop("column_labels", False):
        labels = labels[:, None]
    weight = rng.random(c).astype(np.float32) + 0.5 \
        if opts.pop("weight", False) else None

    jx = paddle.to_tensor(logits, stop_gradient=False)
    j_loss = JF.cross_entropy(
        jx, paddle.to_tensor(labels),
        weight=None if weight is None else paddle.to_tensor(weight), **opts)
    j_loss.sum().backward()

    tx = torch.from_numpy(logits).requires_grad_(True)
    t_loss = TF.cross_entropy(
        tx, torch.from_numpy(labels),
        weight=None if weight is None else torch.from_numpy(weight), **opts)
    t_loss.sum().backward()
    np.testing.assert_allclose(t_loss.detach().numpy(),
                               np.asarray(j_loss._value), **LOSS_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._value),
                               **GRAD_TOL)


@pytest.fixture
def spy(monkeypatch):
    calls = []
    real = tloss.fused_softmax_cross_entropy

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(tloss, "fused_softmax_cross_entropy", counting)
    return calls


def _routed(v, **opts):
    logits, labels = _logits_labels(6, v, seed=v, ignore=(2,))
    return TF.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels), **opts)


def test_routing_follows_the_flag_and_the_vocabulary(spy, fused_flag):
    _routed(8192)
    assert len(spy) == 1
    _routed(8191)                                  # below MIN_VOCAB
    _routed(8192, label_smoothing=0.1)             # plain options
    _routed(8192, weight=torch.ones(8192))
    _routed(8192, use_softmax=False)
    assert len(spy) == 1
    set_flags({"FLAGS_use_fused_cross_entropy": False})
    _routed(8192)
    assert len(spy) == 1


def test_fused_and_plain_routes_agree(fused_flag):
    for reduction in ("mean", "sum", "none"):
        fused = _routed(8192, reduction=reduction)
        set_flags({"FLAGS_use_fused_cross_entropy": False})
        plain = _routed(8192, reduction=reduction)
        set_flags({"FLAGS_use_fused_cross_entropy": True})
        np.testing.assert_allclose(fused.numpy(), plain.numpy(), **LOSS_TOL)


def test_incubate_entry_forces_the_fused_path(spy):
    """Below the vocabulary threshold and with the flag off, the incubate
    entry still takes the fused function (its own import of it), and gives
    `cross_entropy`'s mean."""
    logits, labels = _logits_labels(9, 300, seed=4, ignore=(0,))
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    assert tce.is_eligible(tl, tlab.long(), force=True)
    assert not tce.is_eligible(tl, tlab.long())
    got = incubate_fused(tl, tlab)
    np.testing.assert_allclose(got.numpy(),
                               TF.cross_entropy(tl, tlab).numpy(), **LOSS_TOL)
    assert spy == []        # nn.functional's fused import was not used


def test_masked_reduce_mean_of_no_valid_rows_is_zero():
    nll = torch.tensor([1.0, 2.0])
    labels = torch.tensor([-100, -100])
    assert float(tce.masked_reduce(nll, labels, -100, "mean")) == 0.0
    assert float(tce.masked_reduce(nll, labels, -100, "sum")) == 0.0


def test_wrapper_rejects_malformed_inputs():
    logits = torch.zeros(4, 10)
    with pytest.raises(ValueError, match="labels"):
        tce.cross_entropy_fwd(logits, torch.zeros(3, dtype=torch.long))
    with pytest.raises(TypeError, match="integers"):
        tce.cross_entropy_fwd(logits, torch.zeros(4))
