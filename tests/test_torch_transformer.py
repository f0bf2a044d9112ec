"""Port parity: `paddle_tpu_torch.nn`'s transformer layers vs the JAX
package's (`paddle_tpu/nn/layer/transformer.py`).

Each layer is built by the JAX package from a seed and its weights carried
into the port's layer with `convert.load_jax_state`; the same numpy inputs
(from a seed) go through both, and the forward outputs and the input
gradients of ``sum(out * w)`` (w a fixed random tensor) are compared.
`MultiHeadAttention` at head_dim 64 (E 128, 2 heads: the port takes the
flash route, on CPU tensors the kernels' plain twins, also non-causally
over more keys than queries) and head_dim 16 (E 64, 4 heads: the plain
path), self- and cross-attention, bool and float masks (the plain path on
both sides), three `Cache` decoding steps and a `StaticCache`; the
encoder and decoder layers and stacks pre-LN and post-LN; `Transformer`
with masks.

Tolerance, fp32: 1e-5 absolute and relative on outputs and gradients —
the same products summed in another order by XLA and by PyTorch (and by
the flash twin's tiles), over widths of at most 256.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.nn.functional import attention as tattention

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
# (embed_dim, heads): head_dim 64 takes the flash route in the port, 16 the
# plain path
WIDTHS = {"d64": (128, 2), "d16": (64, 4)}


def _carry(jlayer, tlayer):
    """The JAX layer's weights into the port's; both in eval mode."""
    load_jax_state(tlayer, {n: np.asarray(p._value)
                            for n, p in jlayer.named_parameters()})
    jlayer.eval()
    tlayer.eval()
    return jlayer, tlayer


def _arr(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


class _Inputs:
    """The same numpy arrays as JAX tensors and torch tensors that take
    gradients, with `grads` of each side after a backward."""

    def __init__(self, *arrays):
        self.arrays = arrays
        self.j = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
        self.t = [torch.tensor(a, requires_grad=True) for a in arrays]

    def grads(self):
        return ([x.grad.numpy() for x in self.j],
                [x.grad.numpy() for x in self.t])


def _backward(jout, tout, seed=99):
    """``sum(out * w)`` backward on both sides, w from `seed`."""
    w = _arr(tuple(tout.shape), seed)
    (jout * paddle.to_tensor(w)).sum().backward()
    (tout * torch.from_numpy(w)).sum().backward()


def _close(t, j, what):
    np.testing.assert_allclose(
        t.detach().numpy() if torch.is_tensor(t) else t,
        j.numpy() if hasattr(j, "numpy") else j, err_msg=what, **TOL)


def _check_grads(inputs):
    jg, tg = inputs.grads()
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, f"input {i} gradient")


def _mha(width, **kw):
    e, h = WIDTHS[width]
    paddle.seed(0)
    return _carry(jnn.MultiHeadAttention(e, h, **kw),
                  tnn.MultiHeadAttention(e, h, device="cpu", **kw))


@pytest.mark.parametrize("width", list(WIDTHS))
def test_mha_self_attention(width, monkeypatch):
    jm, tm = _mha(width)
    e, _ = WIDTHS[width]
    routes = []
    real = tattention.FlashAttention.apply
    monkeypatch.setattr(tattention.FlashAttention, "apply",
                        lambda *a: routes.append(a) or real(*a))
    x = _Inputs(_arr((2, 7, e), 1))
    jout, tout = jm(x.j[0]), tm(x.t[0])
    assert tuple(tout.shape) == (2, 7, e)
    _close(tout, jout, "out")
    _backward(jout, tout)
    _check_grads(x)
    # head_dim 64 goes through the flash Function, non-causally
    assert [a[3] for a in routes] == ([False] if width == "d64" else [])


@pytest.mark.parametrize("width", list(WIDTHS))
def test_mha_cross_attention_fewer_queries(width):
    jm, tm = _mha(width)
    e, _ = WIDTHS[width]
    x = _Inputs(_arr((2, 5, e), 2), _arr((2, 9, e), 3), _arr((2, 9, e), 4))
    jout, tout = jm(*x.j), tm(*x.t)
    assert tuple(tout.shape) == (2, 5, e)
    _close(tout, jout, "out")
    _backward(jout, tout)
    _check_grads(x)


def _masks(n, m):
    """A bool mask (True keeps; each query keeps at least one key) and a
    float mask (added to the scores), broadcast over batch and heads."""
    rng = np.random.default_rng(5)
    keep = rng.random((2, 1, n, m)) > 0.4
    keep[..., 0] = True
    add = (rng.standard_normal((1, 1, n, m)) * 2.0).astype(np.float32)
    return {"bool": keep, "float": add}


@pytest.mark.parametrize("kind", ["bool", "float"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_mha_masked(width, kind):
    jm, tm = _mha(width)
    e, _ = WIDTHS[width]
    mask = _masks(5, 9)[kind]
    x = _Inputs(_arr((2, 5, e), 6), _arr((2, 9, e), 7))
    jout = jm(x.j[0], x.j[1], x.j[1], paddle.to_tensor(mask))
    tout = tm(x.t[0], x.t[1], x.t[1], torch.from_numpy(mask))
    _close(tout, jout, "out")
    _backward(jout, tout)
    _check_grads(x)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_mha_cache_decoding(width):
    """Three steps of one token each through a `Cache` from `gen_cache`:
    every step's output, the cache's K and V after each, and the
    gradients of all three steps' outputs with respect to their inputs."""
    jm, tm = _mha(width)
    e, h = WIDTHS[width]
    x = _Inputs(*[_arr((2, 1, e), 10 + s) for s in range(3)])
    jc, tc = jm.gen_cache(x.j[0]), tm.gen_cache(x.t[0])
    assert tuple(tc.k.shape) == (2, 0, h, e // h)
    jouts, touts = [], []
    for s in range(3):
        jout, jc = jm(x.j[s], x.j[s], x.j[s], None, jc)
        tout, tc = tm(x.t[s], x.t[s], x.t[s], None, tc)
        assert isinstance(tc, tnn.MultiHeadAttention.Cache)
        assert tuple(tc.k.shape) == (2, s + 1, h, e // h)
        _close(tout, jout, f"step {s} out")
        _close(tc.k, jc.k, f"step {s} cache k")
        _close(tc.v, jc.v, f"step {s} cache v")
        jouts.append(jout)
        touts.append(tout)
    _backward(paddle.concat(jouts, axis=1), torch.cat(touts, dim=1))
    _check_grads(x)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_mha_static_cache(width):
    jm, tm = _mha(width)
    e, _ = WIDTHS[width]
    x = _Inputs(_arr((2, 4, e), 20), _arr((2, 11, e), 21))
    jc = jm.gen_cache(x.j[1], x.j[1], jnn.MultiHeadAttention.StaticCache)
    tc = tm.gen_cache(x.t[1], x.t[1], tnn.MultiHeadAttention.StaticCache)
    _close(tc.k, jc.k, "static k")
    _close(tc.v, jc.v, "static v")
    jout, tout = jm(x.j[0], None, None, None, jc), tm(x.t[0], None, None,
                                                       None, tc)
    # a static cache hands back the output alone
    assert torch.is_tensor(tout)
    _close(tout, jout, "out")
    _backward(jout, tout)
    _check_grads(x)


def _layer_kw(pre):
    return dict(dropout=0.0, normalize_before=pre)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("pre", [True, False], ids=["pre_ln", "post_ln"])
def test_encoder_layer(pre, activation):
    paddle.seed(0)
    jl, tl = _carry(
        jnn.TransformerEncoderLayer(128, 2, 256, activation=activation,
                                    **_layer_kw(pre)),
        tnn.TransformerEncoderLayer(128, 2, 256, activation=activation,
                                    device="cpu", **_layer_kw(pre)))
    x = _Inputs(_arr((2, 9, 128), 30))
    jout, tout = jl(x.j[0]), tl(x.t[0])
    _close(tout, jout, "out")
    _backward(jout, tout)
    _check_grads(x)


@pytest.mark.parametrize("pre", [True, False], ids=["pre_ln", "post_ln"])
def test_encoder_stack_with_mask(pre):
    paddle.seed(0)
    jnorm = jnn.LayerNorm(64) if pre else None
    tnorm = torch.nn.LayerNorm(64) if pre else None
    jl, tl = _carry(
        jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
            64, 4, 128, **_layer_kw(pre)), 2, jnorm),
        tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
            64, 4, 128, device="cpu", **_layer_kw(pre)), 2, tnorm))
    mask = _masks(9, 9)["bool"]
    x = _Inputs(_arr((2, 9, 64), 31))
    jout = jl(x.j[0], paddle.to_tensor(mask))
    tout = tl(x.t[0], torch.from_numpy(mask))
    _close(tout, jout, "out")
    _backward(jout, tout)
    _check_grads(x)


@pytest.mark.parametrize("pre", [True, False], ids=["pre_ln", "post_ln"])
def test_decoder_layer(pre):
    paddle.seed(0)
    jl, tl = _carry(
        jnn.TransformerDecoderLayer(128, 2, 256, **_layer_kw(pre)),
        tnn.TransformerDecoderLayer(128, 2, 256, device="cpu",
                                    **_layer_kw(pre)))
    x = _Inputs(_arr((2, 6, 128), 40), _arr((2, 10, 128), 41))
    jout, tout = jl(*x.j), tl(*x.t)
    _close(tout, jout, "out")
    _backward(jout, tout)
    _check_grads(x)


@pytest.mark.parametrize("pre", [True, False], ids=["pre_ln", "post_ln"])
def test_decoder_stack_with_masks(pre):
    paddle.seed(0)
    jnorm = jnn.LayerNorm(128) if pre else None
    tnorm = torch.nn.LayerNorm(128) if pre else None
    jl, tl = _carry(
        jnn.TransformerDecoder(jnn.TransformerDecoderLayer(
            128, 2, 256, **_layer_kw(pre)), 2, jnorm),
        tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
            128, 2, 256, device="cpu", **_layer_kw(pre)), 2, tnorm))
    causal = np.where(np.tril(np.ones((6, 6), bool)), 0.0, -1e9) \
        .astype(np.float32)
    memory_mask = _masks(6, 10)["bool"]
    x = _Inputs(_arr((2, 6, 128), 42), _arr((2, 10, 128), 43))
    jout = jl(*x.j, paddle.to_tensor(causal), paddle.to_tensor(memory_mask))
    tout = tl(*x.t, torch.from_numpy(causal), torch.from_numpy(memory_mask))
    _close(tout, jout, "out")
    _backward(jout, tout)
    _check_grads(x)


def test_decoder_incremental_cache_matches_full_pass():
    """Decoding one token at a time through `gen_cache`'s (Cache,
    StaticCache) pairs gives the port what the JAX decoder gives, step by
    step."""
    paddle.seed(0)
    jl, tl = _carry(
        jnn.TransformerDecoder(jnn.TransformerDecoderLayer(
            128, 2, 256, dropout=0.0), 2),
        tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
            128, 2, 256, dropout=0.0, device="cpu"), 2))
    memory = _arr((2, 10, 128), 44)
    jmem, tmem = paddle.to_tensor(memory), torch.from_numpy(memory)
    jc, tc = jl.gen_cache(jmem), tl.gen_cache(tmem)
    for s in range(3):
        tok = _arr((2, 1, 128), 45 + s)
        jout, jc = jl(paddle.to_tensor(tok), jmem, None, None, jc)
        with torch.no_grad():
            tout, tc = tl(torch.from_numpy(tok), tmem, None, None, tc)
        _close(tout, jout, f"step {s}")
        assert tuple(tc[0][0].k.shape) == (2, s + 1, 2, 64)


def test_transformer_with_masks():
    paddle.seed(0)
    kw = dict(d_model=64, nhead=4, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=128, dropout=0.0,
              normalize_before=True)
    jt, tt = _carry(jnn.Transformer(**kw),
                    tnn.Transformer(device="cpu", **kw))
    src_mask = _masks(8, 8)["bool"]
    tgt_mask = tt.generate_square_subsequent_mask(5)
    np.testing.assert_array_equal(
        tgt_mask.numpy(), jt.generate_square_subsequent_mask(5).numpy())
    memory_mask = _masks(5, 8)["float"]
    x = _Inputs(_arr((2, 8, 64), 50), _arr((2, 5, 64), 51))
    jout = jt(*x.j, paddle.to_tensor(src_mask),
              paddle.to_tensor(tgt_mask.numpy()),
              paddle.to_tensor(memory_mask))
    tout = tt(*x.t, torch.from_numpy(src_mask), tgt_mask,
              torch.from_numpy(memory_mask))
    _close(tout, jout, "out")
    _backward(jout, tout)
    _check_grads(x)


def test_parameter_names_and_shapes_match():
    paddle.seed(0)
    kw = dict(d_model=64, nhead=4, num_encoder_layers=1,
              num_decoder_layers=1, dim_feedforward=128)
    j = {n: tuple(p.shape) for n, p in jnn.Transformer(**kw)
         .named_parameters()}
    t = {n: tuple(p.shape) for n, p in tnn.Transformer(device="cpu", **kw)
         .named_parameters()}
    # the port's Linear weights are [out, in], the reference's [in, out]
    assert set(t) == set(j)
    for name, shape in t.items():
        want = j[name][::-1] if name.endswith("proj.weight") or (
            "linear" in name and name.endswith("weight")) else j[name]
        assert shape == want, name


@pytest.mark.parametrize("make", [
    lambda **kw: tnn.MultiHeadAttention(64, 4, **kw),
    lambda **kw: tnn.TransformerEncoderLayer(64, 4, 128, **kw),
    lambda **kw: tnn.TransformerDecoderLayer(64, 4, 128, **kw),
    lambda **kw: tnn.Transformer(64, 4, 1, 1, 128, **kw)],
    ids=["mha", "encoder_layer", "decoder_layer", "transformer"])
def test_default_device_is_the_card(make):
    """``device=None`` means cuda: without a card the layers raise, and
    build on the CPU only when asked to."""
    assert next(make(device="cpu").parameters()).device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
