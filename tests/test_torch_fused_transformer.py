"""Port parity: the incubate fused transformer family vs the JAX package's
(`paddle_tpu/incubate/nn/functional.py`, `.../fused_transformer.py`), and
the initializers those layers name (`paddle_tpu/nn/initializer.py`).

The five functionals take the same numpy weights on both sides in
Paddle's layout (a linear weight ``[in, out]``, the qkv weight ``[3, H, D,
E]`` or ``[E, 3, H, D]`` with ``trans_qkvw=False``); the layers are built
by the JAX package from a seed and carried across by `convert` (their raw
parameters need no transpose). Forward outputs and the gradients of
``sum(out * w)`` with respect to the inputs and the weights are compared;
attention at head_dim 64 (the port's flash route, the twins on the CPU)
and 16 (the plain path), masked and not, pre-LN and post-LN.

Tolerance, fp32: 1e-5 absolute and relative — the same products summed in
another order, over widths of at most 256; a gradient's absolute
tolerance is 1e-5 times its largest element where that passes 1 (a weight
gradient of a two-layer stack sums terms up to ~17 over every row, and
its rounding scales with them). The initializers draw from
torch's generator, so they are held to the reference's formulas: shape,
the truncation bound, and a sample std within 3% of the formula (the
sample std of n >= 32768 normal draws moves by about 1/sqrt(2n) < 0.4%
relative, so 3% is more than seven sigma; a uniform's by less).
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as jinc
import paddle_tpu.incubate.nn.functional as JF
from paddle_tpu.nn import initializer as JI

from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.incubate import nn as tinc
from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.nn import initializer as TI
from paddle_tpu_torch.nn.functional import attention as tattention

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
STD_RTOL = 0.03
NO_DROPOUT = dict(dropout_rate=0.0, attn_dropout_rate=0.0)


def _arr(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


class _Args:
    """The same numpy arrays as JAX and torch tensors that take gradients
    (None passes through as None)."""

    def __init__(self, **arrays):
        self.names = list(arrays)
        self.j = {n: None if a is None else
                  paddle.to_tensor(a, stop_gradient=False)
                  for n, a in arrays.items()}
        self.t = {n: None if a is None else torch.tensor(a, requires_grad=True)
                  for n, a in arrays.items()}

    def check(self, jout, tout, seed=99):
        np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                                   err_msg="out", **TOL)
        w = _arr(tuple(tout.shape), seed)
        (jout * paddle.to_tensor(w)).sum().backward()
        (tout * torch.from_numpy(w)).sum().backward()
        for n in self.names:
            if self.t[n] is None:
                continue
            tg, jg = self.t[n].grad, self.j[n].grad
            if tg is None or jg is None:
                # a term the call does not read (pre-LN's post-LN
                # affine, say): no gradient on either side
                assert tg is None and (jg is None or not jg.numpy().any()), n
                continue
            jg = jg.numpy()
            # a weight's gradient sums over every row: its rounding
            # scales with its largest element
            np.testing.assert_allclose(
                tg.numpy(), jg, rtol=TOL["rtol"],
                atol=TOL["atol"] * max(1.0, float(np.abs(jg).max())),
                err_msg=f"gradient of {n}")


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear(transpose, bias):
    w = _arr((24, 16) if transpose else (16, 24), 1, 0.2)
    a = _Args(x=_arr((3, 5, 16), 2), weight=w,
              bias=_arr((24,), 3) if bias else None)
    jout = JF.fused_linear(**a.j, transpose_weight=transpose)
    tout = TF.fused_linear(**a.t, transpose_weight=transpose)
    assert tuple(tout.shape) == (3, 5, 24)
    a.check(jout, tout)


@pytest.mark.parametrize("tx,ty", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("bias", [True, False])
def test_fused_matmul_bias(tx, ty, bias):
    a = _Args(x=_arr((6, 16) if tx else (16, 6), 4),
              y=_arr((8, 6) if ty else (6, 8), 5),
              bias=_arr((8,), 6) if bias else None)
    jout = JF.fused_matmul_bias(**a.j, transpose_x=tx, transpose_y=ty)
    tout = TF.fused_matmul_bias(**a.t, transpose_x=tx, transpose_y=ty)
    assert tuple(tout.shape) == (16, 8)
    a.check(jout, tout)


def _attn_weights(e, h, seed=10):
    d = e // h
    return dict(qkv_weight=_arr((3, h, d, e), seed, 0.1),
                linear_weight=_arr((e, e), seed + 1, 0.1),
                qkv_bias=_arr((3, h, d), seed + 2, 0.1),
                linear_bias=_arr((e,), seed + 3, 0.1),
                pre_ln_scale=1.0 + _arr((e,), seed + 4, 0.1),
                pre_ln_bias=_arr((e,), seed + 5, 0.1),
                ln_scale=1.0 + _arr((e,), seed + 6, 0.1),
                ln_bias=_arr((e,), seed + 7, 0.1))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("pre", [True, False], ids=["pre_ln", "post_ln"])
@pytest.mark.parametrize("e,h", [(128, 2), (64, 4)], ids=["d64", "d16"])
def test_fused_multi_head_attention(e, h, pre, masked, monkeypatch):
    routes = []
    real = tattention.FlashAttention.apply
    monkeypatch.setattr(tattention.FlashAttention, "apply",
                        lambda *a: routes.append(a) or real(*a))
    mask = None
    if masked:
        mask = np.random.default_rng(8).random((2, 1, 7, 7)) > 0.3
        mask[..., 0] = True
    a = _Args(x=_arr((2, 7, e), 9), **_attn_weights(e, h))
    kw = dict(pre_layer_norm=pre, **NO_DROPOUT)
    jout = JF.fused_multi_head_attention(
        **a.j, attn_mask=None if mask is None else paddle.to_tensor(mask),
        **kw)
    tout = TF.fused_multi_head_attention(
        **a.t, attn_mask=None if mask is None else torch.from_numpy(mask),
        **kw)
    a.check(jout, tout)
    assert len(routes) == int(e // h == 64 and not masked)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("pre,residual", [(True, True), (False, True),
                                          (False, False)],
                         ids=["pre_ln", "post_ln", "post_ln_no_residual"])
def test_fused_feedforward(pre, residual, activation):
    a = _Args(x=_arr((2, 5, 64), 20), linear1_weight=_arr((64, 256), 21, 0.1),
              linear2_weight=_arr((256, 64), 22, 0.1),
              linear1_bias=_arr((256,), 23, 0.1),
              linear2_bias=_arr((64,), 24, 0.1),
              ln1_scale=1.0 + _arr((64,), 25, 0.1),
              ln1_bias=_arr((64,), 26, 0.1),
              ln2_scale=1.0 + _arr((64,), 27, 0.1),
              ln2_bias=_arr((64,), 28, 0.1))
    kw = dict(dropout1_rate=0.0, dropout2_rate=0.0, activation=activation,
              pre_layer_norm=pre, add_residual=residual)
    a.check(JF.fused_feedforward(**a.j, **kw),
            TF.fused_feedforward(**a.t, **kw))


@pytest.mark.parametrize("trans_qkvw", [True, False])
@pytest.mark.parametrize("pre", [True, False], ids=["pre_ln", "post_ln"])
def test_fused_multi_transformer(pre, trans_qkvw):
    e, h, f, layers = 128, 2, 256, 2
    arrays = {"x": _arr((2, 6, e), 30)}
    for i in range(layers):
        w = _attn_weights(e, h, seed=40 + 10 * i)
        qkv = w["qkv_weight"] if trans_qkvw \
            else np.ascontiguousarray(w["qkv_weight"].transpose(3, 0, 1, 2))
        arrays.update({
            f"ln_scale{i}": w["pre_ln_scale"], f"ln_bias{i}": w["pre_ln_bias"],
            f"qkv_weight{i}": qkv, f"qkv_bias{i}": w["qkv_bias"],
            f"linear_weight{i}": w["linear_weight"],
            f"linear_bias{i}": w["linear_bias"],
            f"ffn_ln_scale{i}": w["ln_scale"], f"ffn_ln_bias{i}": w["ln_bias"],
            f"ffn1_weight{i}": _arr((e, f), 45 + 10 * i, 0.1),
            f"ffn1_bias{i}": _arr((f,), 46 + 10 * i, 0.1),
            f"ffn2_weight{i}": _arr((f, e), 47 + 10 * i, 0.1),
            f"ffn2_bias{i}": _arr((e,), 48 + 10 * i, 0.1)})
    a = _Args(**arrays)

    # the functional's list arguments, by the per-layer key they gather
    keys = {"ln_scales": "ln_scale", "ln_biases": "ln_bias",
            "qkv_weights": "qkv_weight", "qkv_biases": "qkv_bias",
            "linear_weights": "linear_weight",
            "linear_biases": "linear_bias", "ffn_ln_scales": "ffn_ln_scale",
            "ffn_ln_biases": "ffn_ln_bias", "ffn1_weights": "ffn1_weight",
            "ffn1_biases": "ffn1_bias", "ffn2_weights": "ffn2_weight",
            "ffn2_biases": "ffn2_bias"}

    def call(fn, ts):
        lists = {arg: [ts[f"{key}{i}"] for i in range(layers)]
                 for arg, key in keys.items()}
        return fn(ts["x"], **lists, pre_layer_norm=pre, dropout_rate=0.0,
                  activation="gelu", trans_qkvw=trans_qkvw)

    a.check(call(JF.fused_multi_transformer, a.j),
            call(TF.fused_multi_transformer, a.t))


def test_serving_caches_raise_the_reference_message():
    x = np.zeros((1, 2, 64), np.float32)
    qkv, lin = np.zeros((3, 4, 16, 64), np.float32), np.zeros((64, 64),
                                                               np.float32)
    cases = [
        (lambda m, t: m.fused_multi_head_attention(
            t(x), t(qkv), t(lin), cache_kv=t(x))),
        (lambda m, t: m.fused_multi_transformer(
            t(x), None, None, [t(qkv)], None, [t(lin)], None, None, None,
            [t(lin)], None, [t(lin)], None, cache_kvs=[t(x)])),
        (lambda m, t: m.fused_multi_transformer(
            t(x), None, None, [t(qkv)], None, [t(lin)], None, None, None,
            [t(lin)], None, [t(lin)], None, time_step=1)),
    ]
    for case in cases:
        with pytest.raises(NotImplementedError) as jerr:
            case(JF, paddle.to_tensor)
        with pytest.raises(NotImplementedError) as terr:
            case(TF, torch.from_numpy)
        assert str(terr.value) == str(jerr.value)


def _carry(jlayer, tlayer):
    """The JAX layer's raw parameters into the port's (the same names,
    shapes and layouts: nothing transposes); both in eval mode."""
    j = {n: np.asarray(p._value) for n, p in jlayer.named_parameters()}
    assert {n: tuple(p.shape) for n, p in tlayer.named_parameters()} == \
        {n: a.shape for n, a in j.items()}
    load_jax_state(tlayer, j)
    jlayer.eval()
    tlayer.eval()
    return jlayer, tlayer


def _perturbed(jlayer, seed=60):
    """Move every JAX parameter off its init (LayerNorm ones and zero
    biases would hide a swapped term)."""
    rng = np.random.default_rng(seed)
    for _, p in jlayer.named_parameters():
        v = np.asarray(p._value)
        p._value = paddle.to_tensor(
            (v + rng.standard_normal(v.shape) * 0.05).astype(v.dtype))._value
    return jlayer


def _layer_check(jlayer, tlayer, x, **kw):
    jlayer, tlayer = _carry(_perturbed(jlayer), tlayer)
    a = _Args(x=x)
    a.check(jlayer(a.j["x"], **kw), tlayer(a.t["x"], **kw))


@pytest.mark.parametrize("pre", [True, False], ids=["pre_ln", "post_ln"])
@pytest.mark.parametrize("e,h", [(128, 2), (64, 4)], ids=["d64", "d16"])
def test_fused_multi_head_attention_layer(e, h, pre):
    paddle.seed(0)
    _layer_check(
        jinc.FusedMultiHeadAttention(e, h, normalize_before=pre,
                                     **NO_DROPOUT),
        tinc.FusedMultiHeadAttention(e, h, normalize_before=pre,
                                     device="cpu", **NO_DROPOUT),
        _arr((2, 9, e), 61))


@pytest.mark.parametrize("pre", [True, False], ids=["pre_ln", "post_ln"])
def test_fused_feedforward_layer(pre):
    paddle.seed(0)
    kw = dict(dropout_rate=0.0, activation="gelu", normalize_before=pre)
    _layer_check(jinc.FusedFeedForward(64, 256, **kw),
                 tinc.FusedFeedForward(64, 256, device="cpu", **kw),
                 _arr((2, 5, 64), 62))


@pytest.mark.parametrize("pre", [True, False], ids=["pre_ln", "post_ln"])
def test_fused_encoder_layer_with_mask(pre):
    paddle.seed(0)
    kw = dict(dropout_rate=0.0, activation="gelu", normalize_before=pre)
    mask = np.random.default_rng(63).random((2, 1, 9, 9)) > 0.3
    mask[..., 0] = True
    jl, tl = _carry(_perturbed(
        jinc.FusedTransformerEncoderLayer(128, 2, 256, **kw)),
        tinc.FusedTransformerEncoderLayer(128, 2, 256, device="cpu", **kw))
    a = _Args(x=_arr((2, 9, 128), 64))
    a.check(jl(a.j["x"], paddle.to_tensor(mask)),
            tl(a.t["x"], torch.from_numpy(mask)))


def test_fused_multi_transformer_layer():
    paddle.seed(0)
    _layer_check(jinc.FusedMultiTransformer(128, 2, 256, num_layers=2),
                 tinc.FusedMultiTransformer(128, 2, 256, num_layers=2,
                                            device="cpu"),
                 _arr((2, 7, 128), 65))


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear_layer(transpose):
    paddle.seed(0)
    jl = jinc.FusedLinear(16, 24, transpose_weight=transpose)
    tl = tinc.FusedLinear(16, 24, transpose_weight=transpose, device="cpu")
    assert tuple(tl.weight.shape) == ((24, 16) if transpose else (16, 24))
    _layer_check(jl, tl, _arr((3, 16), 66))


def test_fused_linear_without_bias():
    tl = tinc.FusedLinear(16, 24, bias_attr=False, device="cpu")
    assert tl.bias is None and [n for n, _ in tl.named_parameters()] == \
        ["weight"]
    x = torch.from_numpy(_arr((3, 16), 67))
    torch.testing.assert_close(tl(x), x @ tl.weight, rtol=0, atol=0)


def test_layer_attrs_name_initializers():
    layer = tinc.FusedFeedForward(
        8, 16, linear1_weight_attr=TI.Constant(0.5),
        ln1_scale_attr=TI.Constant(2.0), device="cpu")
    assert torch.all(layer.linear1_weight == 0.5)
    assert torch.all(layer.ln1_scale == 2.0)
    with pytest.raises(TypeError, match="Initializer"):
        tinc.FusedFeedForward(8, 16, linear1_weight_attr="xavier",
                              device="cpu")


@pytest.mark.parametrize("make", [
    lambda **kw: tinc.FusedMultiHeadAttention(64, 4, **kw),
    lambda **kw: tinc.FusedFeedForward(64, 128, **kw),
    lambda **kw: tinc.FusedTransformerEncoderLayer(64, 4, 128, **kw),
    lambda **kw: tinc.FusedMultiTransformer(64, 4, 128, **kw),
    lambda **kw: tinc.FusedLinear(8, 8, **kw)],
    ids=["attention", "feedforward", "encoder_layer", "multi_transformer",
         "linear"])
def test_default_device_is_the_card(make):
    assert next(make(device="cpu").parameters()).device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


# ---- initializers -----------------------------------------------------------

# [in, out] Linear, a conv kernel [out, in, kh, kw], the fused qkv weight
# [3, H, D, E]: each drawn with >= 32768 elements
INIT_SHAPES = [(256, 512), (64, 32, 4, 4), (3, 4, 64, 256)]


@pytest.mark.parametrize("shape", INIT_SHAPES, ids=["linear", "conv", "qkv"])
def test_fans_are_the_reference_rule(shape):
    fi, fo = TI.compute_fans(shape)
    assert (fi, fo) == JI._compute_fans(shape)
    if len(shape) == 4 and shape[0] == 3:
        h, d, e = shape[1:]
        assert (fi, fo) == (h * d * e, 3 * d * e)


@pytest.mark.parametrize("kind", ["normal", "uniform"])
@pytest.mark.parametrize("shape", INIT_SHAPES, ids=["linear", "conv", "qkv"])
def test_xavier_std_follows_the_formula(shape, kind):
    fi, fo = JI._compute_fans(shape)
    gen = torch.Generator().manual_seed(1)
    t = torch.empty(shape)
    if kind == "normal":
        TI.XavierNormal()(t, gen)
        want = math.sqrt(2.0 / (fi + fo))
    else:
        TI.XavierUniform()(t, gen)
        limit = math.sqrt(6.0 / (fi + fo))
        want = limit / math.sqrt(3.0)
        assert float(t.abs().max()) <= limit
    assert abs(float(t.std()) / want - 1.0) <= STD_RTOL
    assert abs(float(t.mean())) <= STD_RTOL * want


def test_truncated_normal_truncates_at_two_std():
    gen = torch.Generator().manual_seed(2)
    t = torch.empty(256, 256)
    TI.TruncatedNormal(mean=0.5, std=0.02)(t, gen)
    assert float(t.min()) >= 0.5 - 0.04 and float(t.max()) <= 0.5 + 0.04
    # the std of N(0, 1) truncated to +-2: sqrt(1 - 4 phi(2) / (2 Phi(2) - 1))
    phi2 = math.exp(-2.0) / math.sqrt(2 * math.pi)
    cut = math.erf(2 / math.sqrt(2))
    want = 0.02 * math.sqrt(1 - 4 * phi2 / cut)
    assert abs(float(t.std()) / want - 1.0) <= STD_RTOL
    # and the draw follows the generator, on any dtype
    u = torch.empty(256, 256, dtype=torch.bfloat16)
    TI.TruncatedNormal(mean=0.5, std=0.02)(u, torch.Generator()
                                           .manual_seed(2))
    assert torch.equal(u, t.to(torch.bfloat16))


def test_constant_and_uniform():
    t = torch.empty(3, 4)
    TI.Constant(1.5)(t)
    assert torch.all(t == 1.5)
    TI.Uniform(-0.25, 0.5)(t, torch.Generator().manual_seed(3))
    assert float(t.min()) >= -0.25 and float(t.max()) <= 0.5
