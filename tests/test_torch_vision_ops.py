"""Port parity: `paddle_tpu_torch.vision.ops` against the JAX package's
`paddle_tpu.vision.ops`, on the same numpy inputs from a seed, and the
cases of the reference's `tests/test_vision_ops_signal.py` (its vision
part) and `tests/test_vision_extras.py` (`TestDeformConv`,
`TestDetectionOps`).

Tolerances, fp32: outputs 1e-5 absolute and relative (the same products
and sums in another order: the port computes every RoI in one gather
where the reference loops, and contracts with the weight by one matmul);
gradients 1e-4 (sums of those products over the samples that meet at an
element). `deform_conv2d`'s outputs and gradients 1e-4 (a contraction
over in-channels x taps of up to 72 terms); `yolo_loss` 1e-4 relative
(a sum over every cell and class of each image). The host ops (`nms`,
`matrix_nms`, `generate_proposals`, `distribute_fpn_proposals`,
`prior_box`) are the same numpy code: indices and boxes equal.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.ops as V

from paddle_tpu_torch.vision import ops as T

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t._value)


def _j(a):
    return paddle.to_tensor(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _grads(jfn, tfn, arrays, seed=99):
    """Outputs and the gradients of sum(out * w) (w from a seed) with
    respect to every array, from both packages."""
    js = [paddle.to_tensor(a) for a in arrays]
    for t in js:
        t.stop_gradient = False
    jout = jfn(*js)
    w = np.random.default_rng(seed).standard_normal(jout.shape) \
        .astype(np.float32)
    paddle.sum(jout * paddle.to_tensor(w)).backward()
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = tfn(*ts)
    (tout * torch.from_numpy(w)).sum().backward()
    zeros = [np.zeros_like(a) for a in arrays]
    jg = [z if t.grad is None else _np(t.grad) for t, z in zip(js, zeros)]
    tg = [z if t.grad is None else _np(t.grad) for t, z in zip(ts, zeros)]
    return _np(jout), _np(tout), jg, tg


def _boxes(rng, r, h, w, scale=1.0):
    x0 = rng.uniform(-2, w * 0.7, r)
    y0 = rng.uniform(-2, h * 0.7, r)
    bw = rng.uniform(0.3, w * 0.6, r)
    bh = rng.uniform(0.3, h * 0.6, r)
    return (np.stack([x0, y0, x0 + bw, y0 + bh], 1) / scale) \
        .astype(np.float32)


# ------------------------------------------------- the reference's cases

def test_box_iou():
    a = np.array([[0, 0, 2, 2]], np.float32)
    b = np.array([[1, 1, 3, 3], [0, 0, 2, 2], [4, 4, 5, 5]], np.float32)
    got = _np(T.box_iou(_t(a), _t(b)))
    np.testing.assert_allclose(got[0], [1 / 7, 1.0, 0.0], rtol=1e-5)
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 7, 20, 20), _boxes(rng, 5, 20, 20)
    np.testing.assert_allclose(_np(T.box_iou(_t(a), _t(b))),
                               _np(V.box_iou(_j(a), _j(b))), **TOL)


def test_nms_basic_and_categories():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                     np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    keep = _np(T.nms(_t(boxes), 0.5, _t(scores)))
    np.testing.assert_array_equal(keep, [0, 2])
    assert keep.dtype == np.int64
    cats = np.array([0, 1, 0], np.int64)
    keep = _np(T.nms(_t(boxes), 0.5, _t(scores), category_idxs=_t(cats)))
    assert set(keep.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("case", ["plain", "ties", "top_k", "categories",
                                  "no_scores"])
def test_nms_indices_equal_reference(case):
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 40, 50, 50)
    scores = rng.random(40).astype(np.float32)
    if case == "ties":
        scores = np.round(scores * 4).astype(np.float32) / 4
    kw = {}
    if case == "top_k":
        kw["top_k"] = 5
    if case == "categories":
        cats = rng.integers(0, 3, 40).astype(np.int64)
        kw = dict(category_idxs=cats, categories=[0, 1, 2], top_k=9)
    if case == "no_scores":
        want = _np(V.nms(_j(boxes), 0.4))
        got = _np(T.nms(_t(boxes), 0.4))
    else:
        jkw = {k: (_j(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        want = _np(V.nms(_j(boxes), 0.4, _j(scores), **jkw))
        got = _np(T.nms(_t(boxes), 0.4, _t(scores), **tkw))
    np.testing.assert_array_equal(got, want)


def test_roi_align_uniform_feature():
    feat = np.full((1, 3, 16, 16), 5.0, np.float32)
    boxes = np.array([[2.0, 2.0, 10.0, 10.0]], np.float32)
    out = T.roi_align(_t(feat), _t(boxes), _t(np.array([1], np.int32)),
                      output_size=4)
    assert list(out.shape) == [1, 3, 4, 4]
    np.testing.assert_allclose(_np(out), 5.0, rtol=1e-5)


def test_roi_pool_exact_bins():
    feat = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    boxes = np.array([[0.0, 0.0, 3.0, 3.0]], np.float32)
    out = T.roi_pool(_t(feat), _t(boxes), _t(np.array([1], np.int32)),
                     output_size=2)
    np.testing.assert_allclose(_np(out)[0, 0], [[5, 7], [13, 15]])


def test_box_coder_roundtrip():
    priors = np.array([[0, 0, 10, 10], [5, 5, 20, 25]], np.float32)
    targets = np.array([[1, 1, 9, 11], [4, 6, 22, 24]], np.float32)
    enc = T.box_coder(_t(priors), [1.0, 1.0, 1.0, 1.0], _t(targets),
                      code_type="encode_center_size")
    dec = T.box_coder(_t(priors), [1.0, 1.0, 1.0, 1.0], enc,
                      code_type="decode_center_size")
    np.testing.assert_allclose(_np(dec), targets, rtol=1e-4, atol=1e-4)


def test_prior_box():
    feat = np.zeros((1, 8, 4, 4), np.float32)
    img = np.zeros((1, 3, 32, 32), np.float32)
    boxes, variances = T.prior_box(_t(feat), _t(img), min_sizes=[8.0],
                                   aspect_ratios=[2.0], flip=True, clip=True)
    assert list(boxes.shape) == [4, 4, 3, 4]
    assert _np(boxes).min() >= 0 and _np(boxes).max() <= 1
    assert list(variances.shape) == [4, 4, 3, 4]


def test_distribute_fpn_proposals_restores_order():
    rois = np.array([[0, 0, 10, 10], [0, 0, 120, 120], [0, 0, 500, 500]],
                    np.float32)
    multi, restore = T.distribute_fpn_proposals(_t(rois), 2, 5, 4, 224)
    assert sum(r.shape[0] for r in multi) == 3
    cat = np.concatenate([_np(r) for r in multi if r.shape[0]])
    np.testing.assert_allclose(cat[_np(restore)[:, 0]], rois)


# ------------------------------------------------- parity with the JAX ops

ROI_CASES = [
    dict(aligned=True, sampling_ratio=-1, spatial_scale=1.0),
    dict(aligned=False, sampling_ratio=3, spatial_scale=0.5),
    dict(aligned=True, sampling_ratio=1, spatial_scale=0.25),
]


@pytest.mark.parametrize("case", range(len(ROI_CASES)))
def test_roi_align_forward_and_grads(case):
    kw = ROI_CASES[case]
    rng = np.random.default_rng(case)
    x = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    scale = kw["spatial_scale"]
    boxes = _boxes(rng, 5, 9, 11, scale)
    num = np.array([2, 3], np.int32)

    def jfn(a, b):
        return V.roi_align(a, b, _j(num), (3, 2), **kw)

    def tfn(a, b):
        return T.roi_align(a, b, _t(num), (3, 2), **kw)

    want, got, jg, tg = _grads(jfn, tfn, [x, boxes])
    np.testing.assert_allclose(got, want, **TOL)
    for name, a, b in zip(("x", "boxes"), tg, jg):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


def test_roi_align_layer_and_empty():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    boxes = _boxes(rng, 3, 8, 8)
    num = np.array([0, 3], np.int32)
    got = _np(T.RoIAlign(2, 1.0)(_t(x), _t(boxes), _t(num)))
    want = _np(V.RoIAlign(2, 1.0)(_j(x), _j(boxes), _j(num)))
    np.testing.assert_allclose(got, want, **TOL)
    empty = T.roi_align(_t(x), _t(boxes[:0]), _t(np.array([0, 0])), 2)
    assert tuple(empty.shape) == (0, 4, 2, 2)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_roi_pool_equals_reference(scale):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 10, 12)).astype(np.float32)
    boxes = _boxes(rng, 6, 10, 12, scale)
    # a box whose bins fall partly outside the map, and a tiny one whose
    # bins are empty
    boxes[0] = [-6, -5, 3, 4]
    boxes[1] = [30, 30, 31, 31]
    num = np.array([4, 2], np.int32)
    want = _np(V.roi_pool(_j(x), _j(boxes), _j(num), (3, 4), scale))
    got = _np(T.roi_pool(_t(x), _t(boxes), _t(num), (3, 4), scale))
    np.testing.assert_allclose(got, want, **TOL)
    got = _np(T.RoIPool((3, 4), scale)(_t(x), _t(boxes), _t(num)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_psroi_pool_equals_reference(scale):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 2 * 3 * 2, 9, 10)).astype(np.float32)
    boxes = _boxes(rng, 5, 9, 10, scale)
    boxes[0] = [-4, -3, 2, 3]
    num = np.array([3, 2], np.int32)
    want = _np(V.psroi_pool(_j(x), _j(boxes), _j(num), (3, 2), scale))
    got = _np(T.psroi_pool(_t(x), _t(boxes), _t(num), (3, 2), scale))
    np.testing.assert_allclose(got, want, **TOL)
    got = _np(T.PSRoIPool((3, 2), scale)(_t(x), _t(boxes), _t(num)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("var", ["list", "tensor", "none"])
def test_box_coder_equals_reference(normalized, var):
    rng = np.random.default_rng(9)
    priors = _boxes(rng, 6, 30, 30) + 1
    targets = _boxes(rng, 6, 30, 30) + 1
    deltas = (rng.standard_normal((6, 4)) * 0.2).astype(np.float32)
    v = {"list": [0.1, 0.1, 0.2, 0.2], "none": None,
         "tensor": rng.uniform(0.1, 0.3, (6, 4)).astype(np.float32)}[var]
    jv = _j(v) if var == "tensor" else v
    tv = _t(v) if var == "tensor" else v
    for code, t in (("encode_center_size", targets),
                    ("decode_center_size", deltas)):
        want = _np(V.box_coder(_j(priors), jv, _j(t), code,
                               box_normalized=normalized))
        got = _np(T.box_coder(_t(priors), tv, _t(t), code,
                              box_normalized=normalized))
        np.testing.assert_allclose(got, want, err_msg=code, **TOL)


@pytest.mark.parametrize("clip,scale_xy", [(True, 1.0), (False, 1.2)])
def test_yolo_box_equals_reference(clip, scale_xy):
    rng = np.random.default_rng(10)
    c = 4
    x = rng.standard_normal((2, 3 * (5 + c), 5, 6)).astype(np.float32)
    img = np.array([[320, 288], [256, 300]], np.int32)
    anchors = [10, 13, 16, 30, 33, 23]
    kw = dict(anchors=anchors, class_num=c, conf_thresh=0.3,
              downsample_ratio=32, clip_bbox=clip, scale_x_y=scale_xy)
    jb, js = V.yolo_box(_j(x), _j(img), **kw)
    tb, ts = T.yolo_box(_t(x), _t(img), **kw)
    np.testing.assert_allclose(_np(tb), _np(jb), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(ts), _np(js), **TOL)


@pytest.mark.parametrize("max_sizes,clip,flip", [(None, True, True),
                                                 ([16.0, 24.0], False,
                                                  False)])
def test_prior_box_equals_reference(max_sizes, clip, flip):
    feat = np.zeros((1, 8, 3, 5), np.float32)
    img = np.zeros((1, 3, 24, 40), np.float32)
    kw = dict(min_sizes=[8.0, 12.0], max_sizes=max_sizes,
              aspect_ratios=[2.0, 3.0], flip=flip, clip=clip)
    jb, jv = V.prior_box(_j(feat), _j(img), **kw)
    tb, tv = T.prior_box(_t(feat), _t(img), **kw)
    np.testing.assert_array_equal(_np(tb), _np(jb))
    np.testing.assert_array_equal(_np(tv), _np(jv))


@pytest.mark.parametrize("pixel_offset", [False, True])
def test_distribute_fpn_proposals_equals_reference(pixel_offset):
    rng = np.random.default_rng(11)
    rois = np.abs(_boxes(rng, 30, 600, 600)) + 1
    j = V.distribute_fpn_proposals(_j(rois), 2, 5, 4, 224,
                                   pixel_offset=pixel_offset,
                                   rois_num=_j(np.array([30], np.int32)))
    t = T.distribute_fpn_proposals(_t(rois), 2, 5, 4, 224,
                                   pixel_offset=pixel_offset,
                                   rois_num=_t(np.array([30], np.int32)))
    for a, b in zip(t[0], j[0]):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(t[1]), _np(j[1]))
    for a, b in zip(t[2], j[2]):
        np.testing.assert_array_equal(_np(a), _np(b))


# ------------------------------------------------------- deformable conv

class TestDeformConv:
    def setup_method(self, _):
        rng = np.random.RandomState(0)
        self.x = rng.randn(2, 4, 8, 8).astype("float32")
        self.w = rng.randn(6, 4, 3, 3).astype("float32")
        self.b = rng.randn(6).astype("float32")
        self.off = np.zeros((2, 18, 6, 6), "float32")

    def test_zero_offset_equals_conv(self):
        got = _np(T.deform_conv2d(_t(self.x), _t(self.off), _t(self.w),
                                  _t(self.b)))
        ref = torch.nn.functional.conv2d(_t(self.x), _t(self.w),
                                         _t(self.b)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4)

    def test_mask_modulation(self):
        m = np.full((2, 9, 6, 6), 0.5, "float32")
        got = _np(T.deform_conv2d(_t(self.x), _t(self.off), _t(self.w),
                                  None, mask=_t(m)))
        ref = 0.5 * torch.nn.functional.conv2d(_t(self.x),
                                               _t(self.w)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4)

    def test_integer_offset_is_shift(self):
        off = self.off.copy()
        off[:, 0::2] = 1.0  # dy=+1 on every tap
        got = _np(T.deform_conv2d(_t(self.x), _t(off), _t(self.w)))
        xs = np.zeros_like(self.x)
        xs[:, :, :-1] = self.x[:, :, 1:]
        ref = torch.nn.functional.conv2d(_t(xs), _t(self.w)).numpy()
        np.testing.assert_allclose(got[:, :, :-1], ref[:, :, :-1],
                                   atol=1e-3)

    def test_layer_and_grad(self):
        layer = T.DeformConv2D(4, 6, 3, device="cpu")
        x = torch.tensor(self.x, requires_grad=True)
        out = layer(x, _t(self.off))
        assert list(out.shape) == [2, 6, 6, 6]
        out.sum().backward()
        assert x.grad is not None and layer.weight.grad is not None


DEFORM_CASES = [
    dict(stride=1, padding=0, dilation=1, deformable_groups=1, groups=1,
         mask=False, bias=True),
    dict(stride=2, padding=1, dilation=1, deformable_groups=2, groups=1,
         mask=True, bias=True),
    dict(stride=1, padding=2, dilation=2, deformable_groups=2, groups=2,
         mask=True, bias=False),
]


@pytest.mark.parametrize("case", range(len(DEFORM_CASES)))
def test_deform_conv2d_forward_and_grads(case):
    kw = dict(DEFORM_CASES[case])
    use_mask, use_bias = kw.pop("mask"), kw.pop("bias")
    rng = np.random.default_rng(20 + case)
    n, cin, h, w, cout, k = 2, 4, 7, 8, 6, 3
    s, p, d = kw["stride"], kw["padding"], kw["dilation"]
    ho = (h + 2 * p - (d * (k - 1) + 1)) // s + 1
    wo = (w + 2 * p - (d * (k - 1) + 1)) // s + 1
    g = kw["deformable_groups"]
    arrays = [rng.standard_normal((n, cin, h, w)).astype(np.float32),
              (rng.standard_normal((n, 2 * g * k * k, ho, wo)) * 1.5)
              .astype(np.float32),
              rng.standard_normal((cout, cin // kw["groups"], k, k))
              .astype(np.float32)]
    if use_mask:
        arrays.append(rng.random((n, g * k * k, ho, wo)).astype(np.float32))
    if use_bias:
        arrays.append(rng.standard_normal(cout).astype(np.float32))

    def call(ops):
        def fn(x, off, wt, *rest):
            rest = list(rest)
            m = rest.pop(0) if use_mask else None
            b = rest.pop(0) if use_bias else None
            return ops.deform_conv2d(x, off, wt, b, mask=m, **kw)
        return fn

    want, got, jg, tg = _grads(call(V), call(T), arrays)
    np.testing.assert_allclose(got, want, **CONV_TOL)
    for i, (a, b) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(a, b, err_msg=f"input {i}", **CONV_TOL)


def test_deform_conv2d_layer_equals_reference():
    rng = np.random.default_rng(30)
    layer = T.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2,
                           device="cpu", seed=3)
    jlayer = V.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2)
    jlayer.weight = _j(_np(layer.weight))
    jlayer.bias = _j(_np(layer.bias))
    x = rng.standard_normal((2, 4, 6, 6)).astype(np.float32)
    off = rng.standard_normal((2, 36, 6, 6)).astype(np.float32)
    m = rng.random((2, 18, 6, 6)).astype(np.float32)
    want = _np(jlayer(_j(x), _j(off), _j(m)))
    got = _np(layer(_t(x), _t(off), _t(m)))
    np.testing.assert_allclose(got, want, **CONV_TOL)
    bound = 1 / np.sqrt(4 * 9)
    assert np.abs(_np(layer.weight)).max() <= bound
    assert T.DeformConv2D(4, 6, 3, bias_attr=False, device="cpu").bias \
        is None


# ------------------------------------------------------------ host ops

def _matrix_nms_inputs(seed):
    rng = np.random.default_rng(seed)
    bboxes = np.stack([_boxes(rng, 12, 40, 40) for _ in range(2)])
    scores = rng.random((2, 3, 12)).astype(np.float32)
    return bboxes, scores


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("normalized", [True, False])
def test_matrix_nms_equals_reference(gaussian, normalized):
    bboxes, scores = _matrix_nms_inputs(40)
    kw = dict(score_threshold=0.2, post_threshold=0.05, nms_top_k=8,
              keep_top_k=10, use_gaussian=gaussian, normalized=normalized,
              return_index=True)
    want = V.matrix_nms(_j(bboxes), _j(scores), **kw)
    got = T.matrix_nms(_t(bboxes), _t(scores), **kw)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))


def test_matrix_nms_decays_overlaps():
    bboxes = np.array([[[0, 0, 10, 10], [1, 1, 11, 11],
                        [50, 50, 60, 60]]], "float32")
    scores = np.concatenate(
        [np.zeros((1, 1, 3), "float32"),
         np.array([[[0.9, 0.8, 0.7]]], "float32")], axis=1)
    out, nums = T.matrix_nms(_t(bboxes), _t(scores), 0.1, 0.0,
                             keep_top_k=10)
    o = _np(out)
    assert int(_np(nums)[0]) == 3
    assert abs(o[:, 1].max() - 0.9) < 1e-6
    assert o[o[:, 2] == 1][0, 1] < 0.8
    assert abs(o[o[:, 2] == 50][0, 1] - 0.7) < 1e-3


@pytest.mark.parametrize("pixel_offset", [False, True])
def test_generate_proposals_equals_reference(pixel_offset):
    rng = np.random.RandomState(0)
    N, A, H, W = 2, 3, 4, 4
    sc = rng.rand(N, A, H, W).astype("float32")
    bd = (rng.randn(N, 4 * A, H, W) * 0.3).astype("float32")
    anchors = np.tile(
        np.array([[0, 0, 15, 15], [4, 4, 31, 31], [2, 2, 7, 7]],
                 "float32"), (H * W, 1)).reshape(H, W, A, 4)
    anchors = anchors + rng.uniform(0, 30, (H, W, 1, 1)).astype("float32")
    var = np.ones_like(anchors)
    ims = np.array([[64, 64], [48, 56]], "float32")
    kw = dict(pre_nms_top_n=30, post_nms_top_n=7, nms_thresh=0.5,
              min_size=1.0, pixel_offset=pixel_offset)
    jr, jn = V.generate_proposals(_j(sc), _j(bd), _j(ims), _j(anchors),
                                  _j(var), **kw)
    tr, tn = T.generate_proposals(_t(sc), _t(bd), _t(ims), _t(anchors),
                                  _t(var), **kw)
    np.testing.assert_array_equal(_np(tn), _np(jn))
    np.testing.assert_array_equal(_np(tr), _np(jr))
    assert 0 < int(_np(tn)[0]) <= 7


@pytest.mark.parametrize("smooth,score", [(True, False), (False, True),
                                          (True, True)])
def test_yolo_loss_forward_and_grad(smooth, score):
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 3 * 9, 5, 5) * 0.5).astype("float32")
    gtb = np.zeros((2, 3, 4), "float32")
    gtb[0, 0] = [40, 40, 30, 30]
    gtb[0, 1] = [12, 70, 70, 50]
    gtb[1, 0] = [20, 60, 25, 18]
    gtb[1, 1] = [65, 15, 120, 90]
    gtl = np.array([[0, 2, 0], [3, 1, 0]], "int64")
    gts = rng.uniform(0.5, 1, (2, 3)).astype("float32")
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
               116, 90, 156, 198, 373, 326]
    kw = dict(anchors=anchors, anchor_mask=[3, 4, 5], class_num=4,
              ignore_thresh=0.5, downsample_ratio=16,
              use_label_smooth=smooth)

    def jfn(a):
        return V.yolo_loss(a, _j(gtb), _j(gtl),
                           gt_score=_j(gts) if score else None, **kw)

    def tfn(a):
        return T.yolo_loss(a, _t(gtb), _t(gtl),
                           gt_score=_t(gts) if score else None, **kw)

    want, got, jg, tg = _grads(jfn, tfn, [x])
    assert got.shape == (2,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tg[0], jg[0], **GRAD_TOL)


def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image
    yy, xx = np.mgrid[0:16, 0:20]
    arr = np.stack([yy * 8, xx * 6, (yy + xx) * 4], -1).astype("uint8")
    fp = str(tmp_path / "t.jpg")
    Image.fromarray(arr).save(fp, quality=95)
    raw = T.read_file(fp)
    np.testing.assert_array_equal(_np(raw), _np(V.read_file(fp)))
    for mode in ("unchanged", "gray", "rgb"):
        got = T.decode_jpeg(raw, mode=mode)
        want = V.decode_jpeg(V.read_file(fp), mode=mode)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(_np(got), _np(want))
    dec = _np(T.decode_jpeg(raw)).transpose(1, 2, 0).astype(int)
    assert dec.shape == (16, 20, 3)
    assert np.abs(dec - arr.astype(int)).mean() < 8
