"""Port parity: the conv-net layers of `paddle_tpu_torch.nn` against the
JAX package's `paddle_tpu.nn` (convolutions and their transposes, pooling,
batch / instance / group / local-response norms, the activations the
vision models use, `Linear`, `Dropout`, `Flatten`, `ChannelShuffle` and
the containers), on the same numpy inputs from a seed, the layers'
weights carried by `convert`.

Tolerances, fp32: 1e-5 absolute and relative (the same sums in another
order: XLA's convolution and pooling against torch's); a batch norm's
buffers 1e-6 (a mean and a variance of the same numbers). bf16 inputs:
each side rounds every product and sum to 8 bits in its own order, so 2
bf16 steps of the output's largest magnitude (2 · 2^-8 · max|out|), and
the running statistics, computed in fp32 on both sides from the same bf16
input, 1e-6.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.nn import functional as TF

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
STAT_ATOL = 1e-6


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _j(a, dtype=None):
    t = paddle.to_tensor(a)
    return t.astype(dtype) if dtype else t


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._value).astype(np.float32)


def _bf16_tol(want):
    return dict(rtol=0, atol=2 * 2.0 ** -8 * float(np.abs(want).max()))


def _state(jlayer):
    arrays = {n: np.asarray(p._value) for n, p in jlayer.named_parameters()}
    arrays.update({n: np.asarray(b._value)
                   for n, b in jlayer.named_buffers()})
    return arrays


# ---- convolutions ----------------------------------------------------------

CONV2D = {
    "int": dict(padding=1),
    "per_dim": dict(padding=[1, 2]),
    "pairs_asym": dict(padding=[1, 0, 2, 1]),
    "same_stride2": dict(padding="SAME", stride=2),
    "same_stride2_dilated": dict(padding="same", stride=2, dilation=2),
    "valid": dict(padding="VALID", stride=2),
    "nhwc_groups_dilation": dict(padding=2, dilation=2, groups=2,
                                 data_format="NHWC"),
    "nhwc_same_stride2": dict(padding="SAME", stride=2, data_format="NHWC"),
}


@pytest.mark.parametrize("case", sorted(CONV2D))
@pytest.mark.parametrize("hw", [(9, 10), (8, 8)], ids=["odd", "even"])
def test_conv2d_matches_jax(case, hw):
    kw = CONV2D[case]
    nhwc = kw.get("data_format") == "NHWC"
    shape = (2, *hw, 4) if nhwc else (2, 4, *hw)
    x = _rand(shape)
    w = _rand((6, 4 // kw.get("groups", 1), 3, 3), seed=1, scale=0.3)
    b = _rand((6,), seed=2)
    want = JF.conv2d(_j(x), _j(w), _j(b), **kw)
    got = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("n,fmt", [(1, "NCL"), (1, "NLC"), (3, "NCDHW"),
                                   (3, "NDHWC")])
@pytest.mark.parametrize("padding", ["SAME", "pairs", "nested"])
def test_conv1d_conv3d_match_jax(n, fmt, padding):
    last = fmt.endswith("C") and fmt not in ("NCL",)
    spatial = (11,) if n == 1 else (5, 6, 7)
    x = _rand((2, *spatial, 3) if last else (2, 3, *spatial))
    w = _rand((4, 3) + (3,) * n, seed=1, scale=0.3)
    flat = [1, 0, 0, 2, 2, 1][:2 * n]
    pad = {"SAME": "SAME", "pairs": flat,
           "nested": [[0, 0], [0, 0]] + [flat[2 * i:2 * i + 2]
                                         for i in range(n)]}[padding]
    if last and padding == "nested":
        # channels last: the batch pair, the spatial pairs, the channel
        # pair; the reference reads padding[2:] whatever the layout
        # (ROADMAP.md Queue 3), so hold the port to the flat pairs
        pad = [[0, 0]] + pad[2:] + [[0, 0]]
        jpad = flat
    else:
        jpad = pad
    fn = {1: (JF.conv1d, TF.conv1d), 3: (JF.conv3d, TF.conv3d)}[n]
    want = fn[0](_j(x), _j(w), None, stride=2, padding=jpad, data_format=fmt)
    got = fn[1](torch.from_numpy(x), torch.from_numpy(w), None, stride=2,
                padding=pad, data_format=fmt)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_conv2d_nested_padding_form():
    """``[[0, 0], [0, 0], [top, bottom], [left, right]]``: the port pads as
    the flat pairs say; the reference's 2-D reading of four entries as
    ``2n`` ints takes the pairs as ints and fails (ROADMAP.md Queue 3)."""
    x, w = _rand((1, 2, 7, 8)), _rand((3, 2, 3, 3), seed=1)
    nested = [[0, 0], [0, 0], [1, 2], [0, 1]]
    want = JF.conv2d(_j(x), _j(w), padding=[1, 2, 0, 1])
    got = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=nested)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    with pytest.raises(Exception):
        JF.conv2d(_j(x), _j(w), padding=nested).numpy()


CONV2D_T = {
    "stride2_pad1_outpad1": dict(stride=2, padding=1, output_padding=1),
    "groups_dilation": dict(stride=2, padding=1, groups=2, dilation=2),
    "asym_pairs": dict(stride=2, padding=[1, 0, 0, 2]),
    "pad_above_kernel": dict(stride=1, padding=3),
    "outpad_above_stride": dict(stride=1, padding=0, output_padding=1),
    "same_stride1": dict(stride=1, padding="SAME"),
    "output_size": dict(stride=2, padding=1, output_size=[12, 13]),
    "nhwc": dict(stride=2, padding=1, output_padding=1, data_format="NHWC"),
}


@pytest.mark.parametrize("case", sorted(CONV2D_T))
def test_conv2d_transpose_matches_jax(case):
    kw = dict(CONV2D_T[case])
    nhwc = kw.get("data_format") == "NHWC"
    x = _rand((2, 6, 7, 4) if nhwc else (2, 4, 6, 7))
    groups = kw.get("groups", 1)
    w = _rand((4, 6 // groups, 3, 3), seed=1, scale=0.3)
    b = _rand((6,), seed=2)
    want = JF.conv2d_transpose(_j(x), _j(w), _j(b), **kw)
    got = TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), **kw)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("n", [1, 3])
def test_conv1d_conv3d_transpose_match_jax(n):
    spatial = (9,) if n == 1 else (4, 5, 3)
    x = _rand((2, 4, *spatial))
    w = _rand((4, 3) + (3,) * n, seed=1, scale=0.3)
    fn = {1: (JF.conv1d_transpose, TF.conv1d_transpose),
          3: (JF.conv3d_transpose, TF.conv3d_transpose)}[n]
    want = fn[0](_j(x), _j(w), None, stride=2, padding=1, output_padding=1)
    got = fn[1](torch.from_numpy(x), torch.from_numpy(w), None, stride=2,
                padding=1, output_padding=1)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_transpose_string_padding_with_stride_raises():
    x, w = torch.zeros(1, 2, 5, 5), torch.zeros(2, 3, 3, 3)
    with pytest.raises(ValueError, match="string padding"):
        TF.conv2d_transpose(x, w, stride=2, padding="SAME")


def test_conv2d_bf16_matches_jax():
    x = _rand((2, 4, 9, 9))
    w = _rand((6, 4, 3, 3), seed=1, scale=0.3)
    want = JF.conv2d(_j(x, "bfloat16"), _j(w, "bfloat16"), padding="SAME",
                     stride=2)
    got = TF.conv2d(torch.from_numpy(x).bfloat16(),
                    torch.from_numpy(w).bfloat16(), padding="SAME", stride=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **_bf16_tol(_np(want)))


LAYERS = {
    "Conv1D": (dict(in_channels=3, out_channels=4, kernel_size=3, stride=2,
                    padding=1), (2, 3, 10)),
    "Conv2D": (dict(in_channels=4, out_channels=6, kernel_size=3, stride=2,
                    padding="SAME", groups=2), (2, 4, 9, 9)),
    "Conv3D": (dict(in_channels=2, out_channels=3, kernel_size=2),
               (1, 2, 4, 5, 4)),
    "Conv1DTranspose": (dict(in_channels=3, out_channels=4, kernel_size=3,
                             stride=2, padding=1), (2, 3, 6)),
    "Conv2DTranspose": (dict(in_channels=4, out_channels=2, kernel_size=3,
                             stride=2, padding=1, output_padding=1),
                        (2, 4, 5, 6)),
    "Conv3DTranspose": (dict(in_channels=2, out_channels=3, kernel_size=2,
                             stride=2), (1, 2, 3, 2, 3)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_conv_layers_match_jax(name):
    """Each layer with the JAX layer's weights: the same output; names,
    shapes and the default init's bound, U(±1/sqrt(fan_in)) for weight and
    bias alike."""
    kw, shape = LAYERS[name]
    paddle.seed(0)
    jl = getattr(jnn, name)(**kw)
    tl = getattr(tnn, name)(**kw, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    dims = int(name[4])
    fan_in = kw["in_channels"] * kw["kernel_size"] ** dims \
        // kw.get("groups", 1)
    bound = fan_in ** -0.5
    assert all(float(p.abs().max()) <= bound for p in tl.parameters())
    assert float(tl.weight.abs().max()) > bound / 2
    load_jax_state(tl, _state(jl))
    x = _rand(shape, seed=3)
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))), _np(jl(_j(x))),
                               **TOL)


def test_conv_bias_attr_false_and_padding_mode():
    """``bias_attr=False`` leaves no bias; ``padding_mode`` other than
    zeros raises (the reference stores it and pads with zeros anyway,
    ROADMAP.md Queue 3), where the JAX layer quietly ignores it."""
    conv = tnn.Conv2D(2, 3, 3, bias_attr=False, device="cpu")
    assert conv.bias is None and [n for n, _ in conv.named_parameters()] \
        == ["weight"]
    for mode in ("reflect", "replicate", "circular"):
        with pytest.raises(ValueError, match="padding_mode"):
            tnn.Conv2D(2, 3, 3, padding=1, padding_mode=mode, device="cpu")
    paddle.seed(0)
    jl = jnn.Conv2D(2, 3, 3, padding=1, padding_mode="reflect")
    plain = jnn.Conv2D(2, 3, 3, padding=1)
    plain.weight._value, plain.bias._value = jl.weight._value, jl.bias._value
    x = _j(_rand((1, 2, 5, 5)))
    np.testing.assert_array_equal(_np(jl(x)), _np(plain(x)))


def test_layers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for make in (lambda: tnn.Conv2D(2, 3, 3), lambda: tnn.BatchNorm2D(3),
                 lambda: tnn.Linear(3, 4), lambda: tnn.GroupNorm(1, 3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# ---- pooling ---------------------------------------------------------------

POOL2D = {
    # size 5, kernel 2, stride 2, pad 1, ceil_mode: the reference keeps a
    # last window that starts in the pad, torch's ceil_mode drops it
    "ceil_last_window_in_pad": dict(kernel_size=2, stride=2, padding=1,
                                    ceil_mode=True),
    "ceil_no_pad": dict(kernel_size=3, stride=2, ceil_mode=True),
    "resnet_stem": dict(kernel_size=3, stride=2, padding=1),
    "pad_above_half_kernel": dict(kernel_size=3, stride=2, padding=2),
    "same": dict(kernel_size=3, stride=2, padding="SAME"),
    "valid": dict(kernel_size=3, stride=1, padding="VALID"),
    "nhwc": dict(kernel_size=3, stride=2, padding=1, data_format="NHWC"),
}


@pytest.mark.parametrize("case", sorted(POOL2D))
@pytest.mark.parametrize("kind", ["max", "avg", "avg_inclusive"])
def test_pool2d_matches_jax(case, kind):
    kw = dict(POOL2D[case])
    shape = (2, 5, 7, 3) if kw.get("data_format") == "NHWC" else (2, 3, 5, 7)
    x = _rand(shape)
    if kind == "max":
        jf, tf = JF.max_pool2d, TF.max_pool2d
    else:
        jf, tf = JF.avg_pool2d, TF.avg_pool2d
        kw["exclusive"] = kind == "avg"
    want = jf(_j(x), **kw)
    got = tf(torch.from_numpy(x), **kw)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_ceil_mode_keeps_the_window_torch_drops():
    x = torch.from_numpy(_rand((1, 1, 5, 5)))
    got = TF.max_pool2d(x, 2, 2, 1, ceil_mode=True)
    torch_own = torch.nn.functional.max_pool2d(x, 2, 2, 1, ceil_mode=True)
    assert got.shape[-1] == 4 and torch_own.shape[-1] == 3


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool1d_pool3d_match_jax(n, kind):
    shape = (2, 3, 11) if n == 1 else (1, 2, 5, 6, 7)
    x = _rand(shape)
    name = f"{kind}_pool{n}d"
    kw = dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)
    np.testing.assert_allclose(_np(getattr(TF, name)(torch.from_numpy(x),
                                                     **kw)),
                               _np(getattr(JF, name)(_j(x), **kw)), **TOL)


def test_avg_pool2d_divisor_override_matches_jax():
    x = _rand((2, 3, 6, 7))
    kw = dict(kernel_size=3, stride=2, padding=1, divisor_override=4)
    np.testing.assert_allclose(_np(TF.avg_pool2d(torch.from_numpy(x), **kw)),
                               _np(JF.avg_pool2d(_j(x), **kw)), **TOL)


MASKS = {
    "2d_pad": (2, (2, 3, 7, 8), dict(kernel_size=3, stride=2, padding=1)),
    "2d_nhwc": (2, (2, 7, 8, 3), dict(kernel_size=2, stride=2,
                                      data_format="NHWC")),
    "2d_ties": (2, None, dict(kernel_size=2, stride=1)),
    "1d": (1, (2, 3, 9), dict(kernel_size=3, stride=2, padding=1)),
    "3d": (3, (1, 2, 4, 5, 6), dict(kernel_size=2, stride=2)),
}


@pytest.mark.parametrize("case", sorted(MASKS))
def test_max_pool_return_mask_matches_jax(case):
    """Flat indices into each input plane, the first maximum on ties."""
    n, shape, kw = MASKS[case]
    if shape is None:
        x = np.round(_rand((1, 2, 5, 5))).astype(np.float32)   # many ties
    else:
        x = _rand(shape)
    name = f"max_pool{n}d"
    jout, jmask = getattr(JF, name)(_j(x), return_mask=True, **kw)
    tout, tmask = getattr(TF, name)(torch.from_numpy(x), return_mask=True,
                                    **kw)
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
    assert tmask.dtype == torch.int64
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask._value))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_max_unpool_matches_jax(n):
    shape = {1: (2, 3, 10), 2: (2, 3, 6, 8), 3: (1, 2, 4, 6, 4)}[n]
    x = _rand(shape)
    jout, jmask = getattr(JF, f"max_pool{n}d")(_j(x), 2, 2, return_mask=True)
    tout, tmask = getattr(TF, f"max_pool{n}d")(torch.from_numpy(x), 2, 2,
                                               return_mask=True)
    want = getattr(JF, f"max_unpool{n}d")(jout, jmask, 2, 2)
    got = getattr(TF, f"max_unpool{n}d")(tout, tmask, 2, 2)
    np.testing.assert_array_equal(_np(got), _np(want))
    layer = getattr(tnn, f"MaxUnPool{n}D")(2, 2)
    np.testing.assert_array_equal(_np(layer(tout, tmask)), _np(want))


ADAPTIVE = {
    "avg1d": ("adaptive_avg_pool1d", (2, 3, 11), 4, {}),
    "avg2d": ("adaptive_avg_pool2d", (2, 3, 7, 9), (3, 4), {}),
    "avg2d_none": ("adaptive_avg_pool2d", (2, 3, 7, 9), (None, 2), {}),
    "avg2d_nhwc": ("adaptive_avg_pool2d", (2, 7, 9, 3), (3, 1),
                   dict(data_format="NHWC")),
    "avg3d": ("adaptive_avg_pool3d", (1, 2, 5, 6, 7), 2, {}),
    "max1d": ("adaptive_max_pool1d", (2, 3, 11), 4, {}),
    "max2d": ("adaptive_max_pool2d", (2, 3, 7, 9), (3, 4), {}),
    "max3d": ("adaptive_max_pool3d", (1, 2, 5, 6, 7), (2, 3, 3), {}),
}


@pytest.mark.parametrize("case", sorted(ADAPTIVE))
def test_adaptive_pools_match_jax(case):
    name, shape, size, kw = ADAPTIVE[case]
    x = _rand(shape)
    want = getattr(JF, name)(_j(x), size, **kw)
    got = getattr(TF, name)(torch.from_numpy(x), size, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    if name.startswith("adaptive_max"):
        _, jmask = getattr(JF, name)(_j(x), size, return_mask=True)
        _, tmask = getattr(TF, name)(torch.from_numpy(x), size,
                                     return_mask=True)
        np.testing.assert_array_equal(tmask.numpy(),
                                      np.asarray(jmask._value))


POOL_LAYERS = {
    "MaxPool2D": dict(kernel_size=3, stride=2, padding=1, ceil_mode=True),
    "AvgPool2D": dict(kernel_size=3, stride=2, padding=1, exclusive=False),
    "AdaptiveAvgPool2D": dict(output_size=3),
    "AdaptiveMaxPool2D": dict(output_size=(2, 3)),
    "MaxPool1D": dict(kernel_size=2),
    "AvgPool1D": dict(kernel_size=3, padding=1),
}


@pytest.mark.parametrize("name", sorted(POOL_LAYERS))
def test_pool_layers_match_jax(name):
    kw = POOL_LAYERS[name]
    x = _rand((2, 3, 8) if name.endswith("1D") else (2, 3, 7, 9))
    np.testing.assert_allclose(
        _np(getattr(tnn, name)(**kw)(torch.from_numpy(x))),
        _np(getattr(jnn, name)(**kw)(_j(x))), **TOL)


# ---- normalization ---------------------------------------------------------

BN_MODES = {
    "train": dict(training=True),
    "eval": dict(training=False),
    "global_stats": dict(training=True, use_global_stats=True),
}


@pytest.mark.parametrize("mode", sorted(BN_MODES))
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_jax(mode, fmt, dtype):
    """Output and both running statistics after one call."""
    c = 5
    x = _rand((4, 6, 7, c) if fmt == "NHWC" else (4, c, 6, 7), scale=2.0) \
        + 0.5
    mean0 = _rand((c,), seed=1, scale=0.1)
    var0 = np.abs(_rand((c,), seed=2)) + 0.5
    w, b = _rand((c,), seed=3), _rand((c,), seed=4)
    jm, jv = _j(mean0.copy()), _j(var0.copy())
    kw = dict(momentum=0.9, epsilon=1e-5, data_format=fmt, **BN_MODES[mode])
    want = JF.batch_norm(_j(x, dtype), jm, jv, _j(w), _j(b), **kw)
    tm, tv = torch.tensor(mean0), torch.tensor(var0)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = TF.batch_norm(tx, tm, tv, torch.from_numpy(w), torch.from_numpy(b),
                        **kw)
    # the reference's bf16 result is fp32: its fp32 weight promotes it
    assert str(got.dtype).replace("torch.", "") == str(
        np.asarray(want._value).dtype)
    tol = TOL if dtype == "float32" else _bf16_tol(_np(want))
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(tm.numpy(), _np(jm), rtol=0, atol=STAT_ATOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=0,
                               atol=STAT_ATOL * 10)
    moved = mode == "train"
    assert (not np.array_equal(tm.numpy(), mean0)) == moved
    assert (not np.array_equal(tv.numpy(), var0)) == moved


@pytest.mark.parametrize("name,shape", [("BatchNorm1D", (6, 4)),
                                        ("BatchNorm1D", (6, 4, 5)),
                                        ("BatchNorm2D", (3, 4, 5, 5)),
                                        ("BatchNorm3D", (2, 4, 3, 3, 3)),
                                        ("BatchNorm", (3, 4, 5, 5)),
                                        ("SyncBatchNorm", (3, 4, 5, 5))])
def test_batch_norm_layers_match_jax(name, shape):
    """Two training calls then one evaluating call: outputs and the
    ``_mean`` / ``_variance`` buffers, which `state_dict` names as the
    reference's (no ``num_batches_tracked``)."""
    jl = getattr(jnn, name)(4)
    tl = getattr(tnn, name)(4, device="cpu")
    assert list(tl.state_dict()) == ["weight", "bias", "_mean", "_variance"]
    load_jax_state(tl, _state(jl))
    for i, training in enumerate((True, True, False)):
        jl.train() if training else jl.eval()
        tl.train(training)
        x = _rand(shape, seed=10 + i, scale=3.0) + 1.0
        np.testing.assert_allclose(_np(tl(torch.from_numpy(x))),
                                   _np(jl(_j(x))), **TOL)
    np.testing.assert_allclose(tl._mean.numpy(), _np(jl._mean), rtol=0,
                               atol=STAT_ATOL)
    np.testing.assert_allclose(tl._variance.numpy(), _np(jl._variance),
                               rtol=0, atol=STAT_ATOL * 10)


def test_convert_sync_batchnorm_shares_state():
    model = tnn.Sequential(tnn.Conv2D(3, 4, 3, device="cpu"),
                           tnn.BatchNorm2D(4, device="cpu"), tnn.ReLU())
    bn = model[1]
    out = tnn.SyncBatchNorm.convert_sync_batchnorm(model)
    assert out is model and isinstance(model[1], tnn.SyncBatchNorm)
    assert model[1].weight is bn.weight and model[1]._mean is bn._mean
    x = torch.from_numpy(_rand((2, 3, 6, 6)))
    model(x)
    assert not torch.equal(bn._mean, torch.zeros(4))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_jax(fmt, dtype):
    shape = (2, 5, 6, 8) if fmt == "NHWC" else (2, 8, 5, 6)
    x = _rand(shape, scale=2.0)
    w, b = _rand((8,), seed=1), _rand((8,), seed=2)
    want = JF.group_norm(_j(x, dtype), 4, 1e-5, _j(w), _j(b), fmt)
    got = TF.group_norm(torch.from_numpy(x).to(getattr(torch, dtype)), 4,
                        1e-5, torch.from_numpy(w), torch.from_numpy(b), fmt)
    tol = TOL if dtype == "float32" else _bf16_tol(_np(want))
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("name,shape", [("InstanceNorm1D", (2, 3, 9)),
                                        ("InstanceNorm2D", (2, 3, 5, 6)),
                                        ("InstanceNorm3D", (2, 3, 3, 4, 5)),
                                        ("GroupNorm", (2, 6, 5, 6))])
def test_instance_and_group_norm_layers_match_jax(name, shape):
    args = (3, 6) if name == "GroupNorm" else (3,)
    jl = getattr(jnn, name)(*args)
    tl = getattr(tnn, name)(*args, device="cpu")
    assert sorted(n for n, _ in tl.named_parameters()) == sorted(
        n for n, _ in jl.named_parameters())
    state = _state(jl)
    state = {n: np.asarray(a) + 0.1 * (i + 1) for i, (n, a)
             in enumerate(sorted(state.items()))}
    load_jax_state(tl, state)
    for (n, p) in jl.named_parameters():
        p._value = paddle.to_tensor(state[n])._value
    x = _rand(shape, scale=2.0)
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))), _np(jl(_j(x))),
                               **TOL)


@pytest.mark.parametrize("size", [3, 4, 5])
def test_local_response_norm_matches_jax(size):
    x = _rand((2, 7, 4, 5), scale=3.0)
    kw = dict(size=size, alpha=1e-2, beta=0.75, k=2.0)
    np.testing.assert_allclose(
        _np(tnn.LocalResponseNorm(**kw)(torch.from_numpy(x))),
        _np(jnn.LocalResponseNorm(**kw)(_j(x))), **TOL)


# ---- activations, common layers, containers --------------------------------

ACTS = {
    "relu": {}, "relu6": {}, "sigmoid": {}, "tanh": {}, "silu": {},
    "swish": {}, "hardswish": {}, "hardsigmoid": {},
    "hardsigmoid_slope": dict(slope=0.2, offset=0.4),
    "leaky_relu": dict(negative_slope=0.1), "elu": dict(alpha=0.7),
    "celu": dict(alpha=1.3), "selu": {}, "softplus": dict(beta=2,
                                                          threshold=5),
    "softsign": {}, "hardtanh": dict(min=-0.5, max=2.0), "mish": {},
    "tanhshrink": {}, "hardshrink": dict(threshold=0.3),
    "softshrink": dict(threshold=0.3), "thresholded_relu": {},
    "log_sigmoid": {}, "gelu": {}, "gelu_tanh": dict(approximate=True),
    "softmax": dict(axis=1), "log_softmax": dict(axis=-1),
}


@pytest.mark.parametrize("case", sorted(ACTS))
def test_activations_match_jax(case):
    name = case.replace("_slope", "").replace("_tanh", "")
    x = _rand((3, 4, 5), scale=4.0)
    want = getattr(JF, name)(_j(x), **ACTS[case])
    got = getattr(TF, name)(torch.from_numpy(x), **ACTS[case])
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("name,args", [
    ("ReLU", ()), ("ReLU6", ()), ("Hardswish", ()), ("Hardsigmoid", ()),
    ("Swish", ()), ("Softmax", (1,)), ("LeakyReLU", (0.2,)), ("GELU", ())])
def test_activation_layers_match_jax(name, args):
    x = _rand((2, 3, 4), scale=4.0)
    np.testing.assert_allclose(
        _np(getattr(tnn, name)(*args)(torch.from_numpy(x))),
        _np(getattr(jnn, name)(*args)(_j(x))), **TOL)


def test_linear_matches_jax():
    """Paddle's ``[in, out]`` weight carried into torch's ``[out, in]``;
    ``bias_attr=False`` leaves no bias."""
    jl = jnn.Linear(6, 4)
    tl = tnn.Linear(6, 4, device="cpu")
    assert isinstance(tl, torch.nn.Linear) and tl.weight.shape == (4, 6)
    assert float(tl.bias.abs().max()) == 0.0
    load_jax_state(tl, _state(jl))
    x = _rand((3, 6))
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))), _np(jl(_j(x))),
                               **TOL)
    assert tnn.Linear(6, 4, bias_attr=False, device="cpu").bias is None


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("axis", [None, 1])
def test_dropout_rule(mode, axis):
    """The masks are torch's draws; the rule is the reference's: kept
    elements scaled by 1 / (1 - p) in training (upscale) or by 1 - p at
    inference (downscale), a whole slice per index of `axis`."""
    torch.manual_seed(0)
    p = 0.3
    layer = tnn.Dropout(p, axis=axis, mode=mode)
    x = torch.ones(8, 1024, 4)
    out = layer(x)
    kept = out != 0
    scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
    assert torch.allclose(out[kept], torch.full_like(out[kept], scale))
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.05
    if axis == 1:
        assert bool((kept == kept[:1, :, :1]).all())
    layer.eval()
    want = x * (1 - p) if mode == "downscale_in_infer" else x
    assert torch.equal(layer(x), want)
    jl = jnn.Dropout(p, axis=axis, mode=mode)
    jl.eval()
    np.testing.assert_array_equal(_np(jl(_j(x.numpy()))), want.numpy())


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_channel_shuffle_and_flatten_match_jax(fmt):
    x = _rand((2, 6, 3, 6))
    np.testing.assert_array_equal(
        _np(tnn.ChannelShuffle(3, fmt)(torch.from_numpy(x))),
        _np(jnn.ChannelShuffle(3, fmt)(_j(x))))
    np.testing.assert_array_equal(
        _np(tnn.Flatten(1, 2)(torch.from_numpy(x))),
        _np(jnn.Flatten(1, 2)(_j(x))))
    t = torch.from_numpy(x)
    assert tnn.Identity(3, foo=1)(t) is t


def test_containers_keep_the_reference_names():
    def make(mod, **dev):
        conv = mod.Conv2D(2, 3, 1, **dev)
        norm = mod.BatchNorm2D(3, **dev)
        return (mod.Sequential(conv, mod.ReLU(), norm),
                mod.Sequential(("conv", mod.Conv2D(2, 3, 1, **dev)),
                               ("bn", mod.BatchNorm2D(3, **dev))),
                mod.LayerList([mod.Conv2D(2, 3, 1, **dev),
                               mod.BatchNorm2D(3, **dev)]))
    for jc, tc in zip(make(jnn), make(tnn, device="cpu")):
        assert list(tc.state_dict()) == list(jc.state_dict())
    pairs = tnn.Sequential([("a", tnn.ReLU()), ("b", tnn.ReLU6())])
    assert [n for n, _ in pairs.named_children()] == ["a", "b"]
