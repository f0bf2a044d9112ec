"""Port parity: paddle_tpu_torch fused bias + dropout + residual + LayerNorm
vs the JAX package's.

  * `kernels.fused_ln.fused_bias_residual_layer_norm` (on the CPU: the
    plain twin forward, the plain formula's VJP backward) against the JAX
    kernel in Pallas interpret mode: forward within 1e-5 and all five
    gradients within 1e-4 (fp32; the same formula, summed in another order
    — the tolerances of tests/test_fused_kernels.py), at a row count that
    is not a multiple of the TPU's row block, and bf16 within one bf16
    rounding step of the output;
  * `incubate.nn.functional.fused_bias_dropout_residual_layer_norm` and
    the layer `FusedBiasDropoutResidualLayerNorm` against the JAX ones on
    converted weights: the fused route (d % 128 == 0), the composite
    route (d % 128 != 0, the flag off), and the deterministic dropout
    routes (``downscale_in_infer`` at inference, p = 1 in training), 1e-5;
  * routing: dropout in training and ineligible widths never reach the
    kernel's Function; absent affine terms default to zeros / ones.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import \
    FusedBiasDropoutResidualLayerNorm as JLayer
from paddle_tpu.incubate.nn import functional as JFF
from paddle_tpu.kernels.fused_ln import \
    fused_bias_residual_layer_norm as j_fused_ln

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework import get_flags, set_flags
from paddle_tpu_torch.incubate.nn import FusedBiasDropoutResidualLayerNorm
from paddle_tpu_torch.incubate.nn import functional as TFF
from paddle_tpu_torch.kernels import fused_ln

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 output: the same fp32 value on both sides up to summation order,
# then one rounding to bf16 — at most one bf16 step (2^-7 relative) apart
BF16_TOL = dict(rtol=8e-3, atol=1e-3)


def _inputs(r, d, seed=0, lead=None):
    rng = np.random.default_rng(seed)
    shape = (r, d) if lead is None else (*lead, d)
    return [rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            *(rng.standard_normal(d).astype(np.float32) for _ in range(3))]


@pytest.mark.parametrize("r,d", [(200, 256), (77, 128), (8, 768)])
def test_forward_and_all_grads_match_pallas_interpret(r, d):
    arrs = _inputs(r, d, seed=r)
    rng = np.random.default_rng(1)
    g = rng.standard_normal((r, d)).astype(np.float32)
    j_out, vjp = jax.vjp(
        lambda *a: j_fused_ln(*a, 1e-5, True), *map(jnp.asarray, arrs))
    j_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out = fused_ln.fused_bias_residual_layer_norm(*ts, 1e-5)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **FWD_TOL)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    assert len(grads) == 5
    for name, got, want in zip(("x", "residual", "bias", "scale", "shift"),
                               grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD_TOL)


def test_bf16_forward_matches_pallas_interpret():
    arrs = _inputs(40, 256, seed=3)
    j_out = j_fused_ln(jnp.asarray(arrs[0], jnp.bfloat16),
                       jnp.asarray(arrs[1], jnp.bfloat16),
                       *(jnp.asarray(a, jnp.bfloat16) for a in arrs[2:]),
                       1e-5, True)
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    out = fused_ln.fused_ln_fwd(*ts)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(j_out, np.float32), **BF16_TOL)


def test_twin_uses_centred_fp32_variance():
    """A large common offset: a one-pass E[z^2] - E[z]^2 in fp32 would lose
    the variance; the two-pass twin keeps it."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32)
                         + 3e3)
    zero = torch.zeros(128)
    out = fused_ln.fused_ln_reference(x, torch.zeros_like(x), zero,
                                      torch.ones(128), zero)
    want = torch.nn.functional.layer_norm(x.double(), (128,)).float()
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_wrapper_checks_shapes():
    x = torch.zeros(3, 128)
    with pytest.raises(ValueError):
        fused_ln.fused_ln_fwd(x, torch.zeros(3, 256), torch.zeros(128),
                              torch.ones(128), torch.zeros(128))
    with pytest.raises(ValueError):
        fused_ln.fused_ln_fwd(x, x, torch.zeros(64), torch.ones(128),
                              torch.zeros(128))


def test_eligibility_rule_is_the_reference_rule():
    assert fused_ln.is_eligible(None, 768)
    assert not fused_ln.is_eligible(None, 64)
    assert not fused_ln.is_eligible(None, 768 + 64)
    assert fused_ln.is_eligible(None, 65536)
    assert not fused_ln.is_eligible(None, 65536 + 128)
    assert get_flags("FLAGS_use_fused_layer_norm")[
        "FLAGS_use_fused_layer_norm"] is True


# ---------------------------------------------------------------------------
# the functional and the layer vs the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture
def no_kernel_route(monkeypatch):
    """Fail any call that reaches the fused kernel's Function."""
    def refuse(*a, **k):
        raise AssertionError("the fused kernel route was taken")
    monkeypatch.setattr(fused_ln, "fused_bias_residual_layer_norm", refuse)


def _functional_pair(arrs, **kw):
    x, res, b, s, sh = arrs
    j = JFF.fused_bias_dropout_residual_layer_norm(
        paddle.to_tensor(x), paddle.to_tensor(res), paddle.to_tensor(b),
        paddle.to_tensor(s), paddle.to_tensor(sh), **kw)
    t = TFF.fused_bias_dropout_residual_layer_norm(
        *(torch.from_numpy(a) for a in arrs), **kw)
    return t.numpy(), j.numpy()


@pytest.mark.parametrize("lead,d", [((2, 8), 128), ((3, 5), 256)])
def test_functional_fused_route_matches_jax(lead, d):
    arrs = _inputs(None, d, seed=d, lead=lead)
    got, want = _functional_pair(arrs, dropout_rate=0.0, training=False)
    assert got.shape == (*lead, d)
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("kw", [
    dict(dropout_rate=0.0, training=False),                     # d % 128
    dict(dropout_rate=0.3, training=False, mode="downscale_in_infer"),
    dict(dropout_rate=1.0, training=True),
])
def test_functional_composite_routes_match_jax(kw, no_kernel_route):
    d = 64 if kw["dropout_rate"] == 0.0 else 128
    got, want = _functional_pair(_inputs(None, d, seed=7, lead=(2, 6)), **kw)
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_flag_off_takes_composite_route(no_kernel_route):
    arrs = _inputs(None, 128, seed=9, lead=(4,))
    set_flags({"FLAGS_use_fused_layer_norm": False})
    try:
        got, want = _functional_pair(arrs, dropout_rate=0.0, training=False)
    finally:
        set_flags({"FLAGS_use_fused_layer_norm": True})
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_training_dropout_is_composite_and_upscaled(no_kernel_route):
    """Dropout in training never reaches the kernel (its mask is torch's,
    not JAX's bits); with a zero residual, bias and a constant x the kept
    elements are x / (1 - p) and the dropped ones 0 before the LayerNorm."""
    torch.manual_seed(0)
    x = torch.full((64, 128), 2.0)
    h = TFF._dropout(x, 0.5, True, "upscale_in_train")
    assert set(torch.unique(h).tolist()) <= {0.0, 4.0}
    assert 0.3 < float((h == 0).float().mean()) < 0.7
    out = TFF.fused_bias_dropout_residual_layer_norm(
        x, torch.zeros_like(x), dropout_rate=0.5, training=True)
    assert out.shape == x.shape and torch.isfinite(out).all()


def test_absent_affine_terms_default_to_identity():
    arrs = _inputs(None, 128, seed=11, lead=(3,))
    x, res = (torch.from_numpy(a) for a in arrs[:2])
    got = TFF.fused_bias_dropout_residual_layer_norm(x, res, dropout_rate=0.0,
                                                     training=False)
    want = JFF.fused_bias_dropout_residual_layer_norm(
        paddle.to_tensor(arrs[0]), paddle.to_tensor(arrs[1]),
        dropout_rate=0.0, training=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)


def test_functional_x_grad_matches_jax():
    arrs = _inputs(None, 128, seed=13, lead=(4,))
    xj = paddle.to_tensor(arrs[0], stop_gradient=False)
    out = JFF.fused_bias_dropout_residual_layer_norm(
        xj, paddle.to_tensor(arrs[1]), paddle.to_tensor(arrs[2]),
        paddle.to_tensor(arrs[3]), paddle.to_tensor(arrs[4]),
        dropout_rate=0.0, training=False)
    (out * out).sum().backward()
    xt = torch.from_numpy(arrs[0]).requires_grad_(True)
    out_t = TFF.fused_bias_dropout_residual_layer_norm(
        xt, *(torch.from_numpy(a) for a in arrs[1:]), dropout_rate=0.0,
        training=False)
    (out_t * out_t).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), xj.grad.numpy(), **GRAD_TOL)


def _jax_layer(d, seed):
    paddle.seed(seed)
    layer = JLayer(d, dropout_rate=0.0)
    layer.eval()
    rng = np.random.default_rng(seed)
    for _, p in layer.named_parameters():
        p.set_value(jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)))
    return layer


@pytest.mark.parametrize("d", [128, 96])
def test_layer_with_converted_weights_matches_jax(d):
    jl = _jax_layer(d, seed=d)
    tl = FusedBiasDropoutResidualLayerNorm(d, dropout_rate=0.0,
                                           device="cpu").eval()
    arrays = {n: np.asarray(p._value) for n, p in jl.named_parameters()}
    load_jax_state(tl, arrays)
    # the round trip: the port's parameters are the JAX layer's values
    for n, p in tl.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), arrays[n])
    assert sorted(arrays) == ["linear_bias", "ln_bias", "ln_scale"]
    rng = np.random.default_rng(d + 1)
    x, res = (rng.standard_normal((2, 5, d)).astype(np.float32)
              for _ in range(2))
    want = jl(paddle.to_tensor(x), paddle.to_tensor(res)).numpy()
    got = tl(torch.from_numpy(x), torch.from_numpy(res))
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)


def test_layer_defaults_and_device_rule():
    layer = FusedBiasDropoutResidualLayerNorm(128, device="cpu")
    assert layer.dropout_rate == 0.5 and layer.training
    np.testing.assert_array_equal(layer.ln_scale.detach().numpy(), 1.0)
    np.testing.assert_array_equal(layer.linear_bias.detach().numpy(), 0.0)
    np.testing.assert_array_equal(layer.ln_bias.detach().numpy(), 0.0)
    assert layer.ln_scale.device.type == "cpu"
    if torch.cuda.is_available():
        assert FusedBiasDropoutResidualLayerNorm(128).ln_scale.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            FusedBiasDropoutResidualLayerNorm(128)
