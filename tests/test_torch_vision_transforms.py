"""Port parity: `paddle_tpu_torch.vision.transforms` (the functionals and
every transform class) and `vision.datasets` against the JAX package's, on
the same numpy images from a seed, and the cases of the reference's
`tests/test_vision_extras.py` (`TestTransformFunctionals`,
`TestFlowersVOC`).

Tolerances: float outputs 1e-5 absolute and relative (`resize` is
torch's antialiased interpolation against `jax.image.resize`, the same
filter weights in another order; the warps sample through each package's
own `grid_sample`). A uint8 output is truncated after the float result,
so a float difference of 1e-6 can move it by one level where the value
sits at an integer: uint8 outputs differ by at most 1 level, on at most
1% of their elements (`_assert_uint8_close`). Everything else (crops,
flips, pads, erasing, the colour ops' numpy arithmetic, the datasets'
arrays, the random draws) is equal.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu.vision.datasets as JD
import paddle_tpu.vision.transforms as JT
import paddle_tpu.vision.transforms.functional as JTF

import paddle_tpu_torch.vision as tvision
from paddle_tpu_torch.vision import datasets as TD
from paddle_tpu_torch.vision import transforms as TT
from paddle_tpu_torch.vision.transforms import functional as TTF

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
UINT8_SHARE = 0.01


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    if hasattr(t, "_value"):
        return np.asarray(t._value)
    return np.asarray(t)


def _assert_uint8_close(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= UINT8_SHARE, (diff > 0).mean()


def _assert_same(got, want, level=None):
    """Equal within TOL, or a uint8 output by `_assert_uint8_close`.
    `level`: the size of one uint8 level in a float output computed from
    a uint8 resize or warp (1/255 after `ToTensor`, 1/std after
    `Normalize`); such an output may differ by one level on at most
    UINT8_SHARE of its elements."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == np.uint8:
        _assert_uint8_close(got, want)
        return
    got, want = got.astype(np.float32), want.astype(np.float32)
    if level is not None:
        off = ~np.isclose(got, want, **TOL)
        assert (off.mean() <= UINT8_SHARE and np.abs(
            got - want)[off].max(initial=0) <= level * (1 + 1e-5)), (
            off.mean(), np.abs(got - want).max())
        return
    np.testing.assert_allclose(got, want, **TOL)


def _img(shape=(8, 10, 3), seed=0, dtype="uint8"):
    rng = np.random.RandomState(seed)
    if dtype == "uint8":
        return (rng.rand(*shape) * 255).astype("uint8")
    return rng.rand(*shape).astype("float32")


# ------------------------------------------------- the reference's cases

class TestTransformFunctionals:
    img = _img()

    def test_rotate_90_square(self):
        sq = _img((9, 9, 3), seed=1)
        np.testing.assert_array_equal(
            TTF.rotate(sq, 90, interpolation="nearest"), np.rot90(sq, 1))

    def test_rotate_identity(self):
        np.testing.assert_array_equal(TTF.rotate(self.img, 0), self.img)

    def test_affine_translate(self):
        t = TTF.affine(self.img, 0, (2, 1), 1.0, (0, 0))
        np.testing.assert_array_equal(t[1:, 2:], self.img[:-1, :-2])

    def test_perspective_identity_and_translate(self):
        pts = [(0, 0), (9, 0), (9, 7), (0, 7)]
        np.testing.assert_array_equal(
            TTF.perspective(self.img, pts, pts), self.img)
        dst = [(1, 0), (10, 0), (10, 7), (1, 7)]
        pt = TTF.perspective(self.img, pts, dst)
        np.testing.assert_array_equal(pt[:, 1:], self.img[:, :-1])

    def test_color_ops(self):
        assert TTF.adjust_brightness(self.img, 2.0).dtype == np.uint8
        assert TTF.to_grayscale(self.img).shape == (8, 10, 1)
        assert TTF.to_grayscale(self.img, 3).shape == (8, 10, 3)
        h1 = TTF.adjust_hue(TTF.adjust_hue(self.img, 0.5), 0.5)
        assert np.abs(h1.astype(int) - self.img.astype(int)).max() <= 2
        with pytest.raises(ValueError):
            TTF.adjust_hue(self.img, 0.7)

    def test_crop_pad_erase(self):
        assert TTF.crop(self.img, 1, 2, 3, 4).shape == (3, 4, 3)
        assert TTF.center_crop(self.img, 4).shape == (4, 4, 3)
        assert TTF.pad(self.img, 2).shape == (12, 14, 3)
        er = TTF.erase(self.img, 1, 1, 2, 2, 0)
        assert (er[1:3, 1:3] == 0).all()

    def test_random_erasing_random_fill_uint8(self):
        np.random.seed(3)
        img = np.full((32, 32, 3), 128, np.uint8)
        out = TT.RandomErasing(prob=1.0, value="random")(img)
        changed = out != img
        assert changed.any() and out[changed].std() > 1.0


# ------------------------------------------------- parity with the JAX code

@pytest.mark.parametrize("shape,dtype", [((8, 10, 3), "uint8"),
                                         ((3, 8, 10), "float32"),
                                         ((8, 10), "uint8")])
def test_color_functionals_equal_reference(shape, dtype):
    img = _img(shape, seed=2, dtype=dtype)
    for name, args in (("adjust_brightness", (1.7,)),
                       ("adjust_contrast", (0.6,)),
                       ("to_grayscale", (1,)), ("to_grayscale", (3,))):
        _assert_same(getattr(TTF, name)(img, *args),
                     getattr(JTF, name)(img, *args))
    if len(shape) == 3:
        _assert_same(TTF.adjust_hue(img, 0.2), JTF.adjust_hue(img, 0.2))
        _assert_same(TTF.adjust_saturation(img, 1.4),
                     JTF.adjust_saturation(img, 1.4))
    else:
        # a 2-D image has no colour to saturate: both raise
        for F in (TTF, JTF):
            with pytest.raises(ValueError):
                F.adjust_saturation(img, 1.4)


def test_functionals_on_tensors_return_cpu_float_tensors():
    img = _img((3, 6, 7), seed=3, dtype="float32")
    got = TTF.adjust_brightness(torch.from_numpy(img), 0.5)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    _assert_same(got, JTF.adjust_brightness(img, 0.5))
    got = TTF.crop(torch.from_numpy(img), 1, 1, 3, 4)
    assert isinstance(got, torch.Tensor)
    _assert_same(got, img[:, 1:4, 1:5])
    t = torch.from_numpy(img.copy())
    assert TTF.erase(t, 0, 0, 2, 2, 9.0, inplace=True) is t
    assert (t[:, :2, :2] == 9).all()


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect",
                                  "symmetric"])
def test_crop_pad_erase_equal_reference(mode):
    img = _img(seed=4)
    for pad in (2, (1, 2), (1, 2, 3, 4)):
        _assert_same(TTF.pad(img, pad, fill=7, padding_mode=mode),
                     JTF.pad(img, pad, fill=7, padding_mode=mode))
    _assert_same(TTF.center_crop(img, (5, 6)), JTF.center_crop(img, (5, 6)))
    _assert_same(TTF.erase(img, 2, 3, 3, 4, 11),
                 JTF.erase(img, 2, 3, 3, 4, 11))


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_warps_equal_reference(interp, dtype):
    img = _img((11, 14, 3), seed=5, dtype=dtype)
    cases = [
        ("rotate", (33.0, interp, False, None, 0)),
        ("rotate", (-71.0, interp, True, None, 3)),
        ("rotate", (20.0, interp, False, (4, 6), 0)),
        ("affine", (15.0, (2, -1), 1.2, (10.0, -4.0), interp, 0)),
        ("affine", (-5.0, (0.5, 1.5), 0.8, 7.0, interp, 5)),
        ("perspective", ([(0, 0), (13, 0), (13, 10), (0, 10)],
                         [(2, 1), (12, 0), (11, 9), (1, 10)], interp, 0)),
    ]
    for name, args in cases:
        got = getattr(TTF, name)(img, *args)
        want = getattr(JTF, name)(img, *args)
        _assert_same(got, want)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "nearest",
                                    "linear", "cubic"])
@pytest.mark.parametrize("layout", ["hwc", "chw", "hw"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_resize_equals_jax(interp, layout, dtype):
    shape = {"hwc": (37, 53, 3), "chw": (3, 37, 53), "hw": (37, 53)}[layout]
    img = _img(shape, seed=6, dtype=dtype)
    for size in ((20, 30), (74, 106), (29, 61), 24):
        _assert_same(TT.resize(img, size, interp),
                     JT.resize(img, size, interp))


def test_resize_rejects_a_method_torch_lacks():
    with pytest.raises(ValueError):
        TT.resize(_img(), (4, 4), "lanczos3")


def test_tensor_functionals_equal_reference():
    img = _img((6, 7, 3), seed=7)
    t = TT.to_tensor(img)
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    _assert_same(t, JT.to_tensor(img))
    _assert_same(TT.to_tensor(img, "HWC"), JT.to_tensor(img, "HWC"))
    _assert_same(TT.to_tensor(img[..., 0]), JT.to_tensor(img[..., 0]))
    mean, std = [0.4, 0.5, 0.6], [0.2, 0.3, 0.25]
    _assert_same(TT.normalize(t, mean, std), JT.normalize(
        JT.to_tensor(img), mean, std))
    _assert_same(TT.normalize(img, mean, std, "HWC"),
                 JT.normalize(img, mean, std, "HWC"))
    for fn in ("hflip", "vflip"):
        _assert_same(getattr(TT, fn)(img), getattr(JT, fn)(img))
        chw = np.ascontiguousarray(img.transpose(2, 0, 1))
        _assert_same(getattr(TT, fn)(chw), getattr(JT, fn)(chw))


# one uint8 level of each pipeline's float output, where a uint8 resize
# comes before its conversion to float (None: no such step)
LEVELS = {0: 1 / 57.0, 1: 1 / 255.0}


def _pipelines(T):
    """Every transform class, with the same arguments in both packages."""
    return [
        T.Compose([T.RandomResizedCrop(16), T.RandomHorizontalFlip(),
                   T.RandomVerticalFlip(), T.Transpose(),
                   T.Normalize([120.0, 115.0, 100.0], [60.0, 58.0, 57.0])]),
        T.Compose([T.Resize(20), T.CenterCrop(12), T.ToTensor()]),
        T.Compose([T.Pad(3, fill=5), T.RandomCrop(10)]),
        T.Compose([T.Pad([1, 2]), T.Resize((9, 7), "nearest")]),
        T.ColorJitter(0.3, 0.3, 0.3, 0.1),
        T.BrightnessTransform(0.4), T.ContrastTransform(0.4),
        T.SaturationTransform(0.4), T.HueTransform(0.2),
        T.Grayscale(3),
        T.RandomRotation(30), T.RandomRotation((10, 40), "bilinear",
                                               expand=True, fill=2),
        T.RandomAffine(15, translate=(0.1, 0.2), scale=(0.8, 1.2),
                       shear=10),
        T.RandomAffine(5, shear=(-3, 3, -4, 4), interpolation="bilinear"),
        T.RandomPerspective(prob=1.0), T.RandomPerspective(prob=0.5),
        T.RandomErasing(prob=1.0), T.RandomErasing(prob=1.0,
                                                   value="random"),
        T.RandomErasing(prob=0.5, value=(1, 2, 3)),
    ]


@pytest.mark.parametrize("index", range(len(_pipelines(JT))))
def test_random_transforms_draw_as_the_reference(index):
    img = _img((24, 30, 3), seed=8)
    for seed in (0, 1, 2):
        np.random.seed(seed)
        want = _pipelines(JT)[index](img)
        after_j = np.random.rand()
        np.random.seed(seed)
        got = _pipelines(TT)[index](img)
        after_t = np.random.rand()
        assert after_t == after_j       # the same number of draws
        _assert_same(got, want, LEVELS.get(index))


# ------------------------------------------------------------- datasets

@pytest.mark.parametrize("cls,modes", [
    ("MNIST", ("train", "test")), ("FashionMNIST", ("train",)),
    ("Cifar10", ("train", "test")), ("Cifar100", ("train",)),
    ("Flowers", ("train", "valid", "test")), ("VOC2012", ("train", "val"))])
def test_datasets_equal_reference(cls, modes):
    for mode in modes:
        t, j = getattr(TD, cls)(mode=mode), getattr(JD, cls)(mode=mode)
        assert len(t) == len(j)
        for i in (0, 1, len(j) - 1):
            for a, b in zip(t[i], j[i]):
                np.testing.assert_array_equal(_np(a), _np(b))
                assert _np(a).dtype == _np(b).dtype


def test_mnist_reads_idx_files(tmp_path):
    import gzip
    import struct
    images = (np.arange(3 * 28 * 28) % 251).astype(np.uint8)
    with gzip.open(tmp_path / "img.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 3, 28, 28) + images.tobytes())
    with gzip.open(tmp_path / "lab.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 3) + bytes([4, 0, 9]))
    kw = dict(image_path=str(tmp_path / "img.gz"),
              label_path=str(tmp_path / "lab.gz"))
    t, j = TD.MNIST(**kw), JD.MNIST(**kw)
    for i in range(3):
        for a, b in zip(t[i], j[i]):
            np.testing.assert_array_equal(_np(a), _np(b))


def test_dataset_folder_and_image_folder(tmp_path):
    rng = np.random.default_rng(9)
    for c in ("cat", "dog"):
        (tmp_path / c).mkdir()
        for k in range(3):
            np.save(tmp_path / c / f"{k}.npy",
                    rng.integers(0, 255, (5, 6, 3), dtype=np.uint8))
    (tmp_path / "dog" / "skip.txt").write_text("not an image")
    transform = TT.Compose([TT.Transpose(), TT.Normalize(100.0, 50.0)])
    jtransform = JT.Compose([JT.Transpose(), JT.Normalize(100.0, 50.0)])
    t = TD.DatasetFolder(str(tmp_path), transform=transform)
    j = JD.DatasetFolder(str(tmp_path), transform=jtransform)
    assert t.class_to_idx == j.class_to_idx == {"cat": 0, "dog": 1}
    assert t.samples == j.samples and len(t) == 6
    for i in range(6):
        (a, la), (b, lb) = t[i], j[i]
        _assert_same(a, b)
        assert la == lb
    (img,) = TD.ImageFolder(str(tmp_path))[4]
    assert img.shape == (5, 6, 3)


def test_image_backend(tmp_path):
    from PIL import Image
    assert tvision.get_image_backend() == "pil"
    with pytest.raises(ValueError):
        tvision.set_image_backend("skimage")
    Image.fromarray(_img((4, 5, 3))).save(tmp_path / "a.png")
    assert tvision.image_load(str(tmp_path / "a.png")).size == (5, 4)
    tvision.set_image_backend("cv2")
    try:
        assert tvision.get_image_backend() == "cv2"
        with pytest.raises(RuntimeError):
            tvision.image_load(str(tmp_path / "a.png"))
    finally:
        tvision.set_image_backend("pil")
