"""Port parity: `paddle_tpu_torch.nn.functional.vision` (`affine_grid`,
`grid_sample`, `temporal_shift`, `zeropad2d`) against the JAX package's
`paddle_tpu.nn.functional.vision`, on the same numpy inputs from a seed,
and the cases of the reference's `tests/test_nn_extras.py::TestGridOps`.

Tolerances, fp32: outputs 1e-5 absolute and relative (the same bilinear
weights in another order of operations); gradients 1e-4 (sums of those
weights over the samples that meet at an element). `temporal_shift` and
`zeropad2d` move values without arithmetic: equal.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF

from paddle_tpu_torch.nn import functional as TF

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
MODES = list(itertools.product(["bilinear", "nearest"],
                               ["zeros", "border", "reflection"],
                               [True, False]))


def _np(t):
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t._value)


def _jax_grads(fn, *arrays):
    ts = [paddle.to_tensor(a) for a in arrays]
    for t in ts:
        t.stop_gradient = False
    out = fn(*ts)
    w = np.random.default_rng(99).standard_normal(out.shape) \
        .astype(np.float32)
    paddle.sum(out * paddle.to_tensor(w)).backward()
    return _np(out), [_np(t.grad) for t in ts], w


def _torch_grads(fn, w, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(w)).sum().backward()
    return _np(out), [_np(t.grad) for t in ts]


def _assert_grads(got, want, names):
    """Gradients equal within GRAD_TOL; no gradient (None: the input
    reaches the output only through rounding) counts as zeros."""
    for name, a, b, shape in zip(names, got, want, names.values()):
        a = np.zeros(shape, np.float32) if a is None else a
        b = np.zeros(shape, np.float32) if b is None else b
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("shape", [[2, 3, 5, 7], [2, 3, 1, 4],
                                   [2, 1, 3, 4, 5]])
def test_affine_grid(shape, align):
    k = len(shape) - 2
    th = np.random.default_rng(0).standard_normal((2, k, k + 1)) \
        .astype(np.float32)
    want = _np(JF.affine_grid(paddle.to_tensor(th), shape,
                              align_corners=align))
    got = _np(TF.affine_grid(torch.from_numpy(th), shape,
                             align_corners=align))
    np.testing.assert_allclose(got, want, **TOL)


def _grid_case(dims, seed):
    rng = np.random.default_rng(seed)
    spatial = (6, 7) if dims == 2 else (4, 5, 6)
    x = rng.standard_normal((2, 3, *spatial)).astype(np.float32)
    g = (rng.random((2, 5, 4, dims) if dims == 2 else (2, 3, 3, 4, dims))
         * 2.6 - 1.3).astype(np.float32)
    return x, g


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("mode,pad,align", MODES)
def test_grid_sample_forward_and_grads(dims, mode, pad, align):
    x, g = _grid_case(dims, seed=dims)

    def jfn(a, b):
        return JF.grid_sample(a, b, mode, pad, align)

    def tfn(a, b):
        return TF.grid_sample(a, b, mode, pad, align)

    want, want_grads, w = _jax_grads(jfn, x, g)
    got, got_grads = _torch_grads(tfn, w, x, g)
    np.testing.assert_allclose(got, want, **TOL)
    _assert_grads(got_grads, want_grads, {"x": x.shape, "grid": g.shape})


@pytest.mark.parametrize("pad", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align", [True, False])
def test_grid_sample_nearest_rounds_half_up(pad, align):
    # grid points that fall exactly halfway between two pixels: the
    # reference rounds them up, floor(c + 0.5), where torch's own
    # nearest mode rounds half to even
    x = np.arange(2 * 1 * 4 * 6, dtype=np.float32).reshape(2, 1, 4, 6)
    size = 6
    half = np.arange(-1, size + 1) + 0.5
    gx = (2 * half / (size - 1) - 1) if align else (
        (2 * half + 1) / size - 1)
    g = np.zeros((2, 1, len(gx), 2), np.float32)
    g[..., 0] = gx.astype(np.float32)
    want = _np(JF.grid_sample(paddle.to_tensor(x), paddle.to_tensor(g),
                              "nearest", pad, align))
    got = _np(TF.grid_sample(torch.from_numpy(x), torch.from_numpy(g),
                             "nearest", pad, align))
    np.testing.assert_array_equal(got, want)


def test_grid_sample_rejects_other_modes():
    x, g = _grid_case(2, 0)
    with pytest.raises(ValueError):
        TF.grid_sample(torch.from_numpy(x), torch.from_numpy(g), "bicubic")
    with pytest.raises(ValueError):
        TF.grid_sample(torch.from_numpy(x), torch.from_numpy(g),
                       padding_mode="wrap")


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_temporal_shift(fmt):
    x = np.random.default_rng(3).standard_normal((6, 8, 2, 3)) \
        .astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    want = _np(JF.temporal_shift(paddle.to_tensor(x), seg_num=3,
                                 shift_ratio=0.25, data_format=fmt))
    got = _np(TF.temporal_shift(torch.from_numpy(x), seg_num=3,
                                shift_ratio=0.25, data_format=fmt))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_zeropad2d(fmt):
    x = np.random.default_rng(4).standard_normal((1, 2, 3, 4)) \
        .astype(np.float32)
    want = _np(JF.zeropad2d(paddle.to_tensor(x), [1, 2, 3, 4],
                            data_format=fmt))
    got = _np(TF.zeropad2d(torch.from_numpy(x), [1, 2, 3, 4],
                           data_format=fmt))
    np.testing.assert_array_equal(got, want)
