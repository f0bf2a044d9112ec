"""Port parity: every conv-net constructor of `paddle_tpu_torch.vision.models`
against the JAX package's (`paddle_tpu/vision/models`), at the reference
test's sizes (tests/test_vision_models.py: 64 x 64; GoogLeNet 224, whose
aux heads need its 14 x 14 grid; Inception-v3 299; LeNet 1 x 28 x 28).

Each model is built with 10 classes; the port's draws from the reference's
initializers (seed 0) are given to the JAX model, whose parameters and
buffers `convert` then carries back into the port; both run a batch of 2
from a numpy seed:

- in evaluation: the logits (all three heads of GoogLeNet);
- in training: the logits, the batch norms normalizing by the batch's
  statistics, and then every ``_mean`` / ``_variance`` after the forward.
  The dropout layers are set to p = 0 on both sides for this forward (a
  mask is each framework's own draw; `test_torch_conv_layers.py` holds
  the port's dropout to its rule).

Tolerances, absolute, as a share of the largest magnitude (deep nets at
their init give logits of very different scales, 1e-11 to 1, so a bound
scales with them): in evaluation 1e-4 (the same sums in another order;
1e-6 is typical); in training 5e-3 (every batch norm renormalizes by
statistics of a batch of 2, whose fp32 rounding the layers after it
amplify: 1.5e-3 seen through ResNet-152), for the logits, each running
variance, and each running mean against the square root of its layer's
variance (a batch mean near 0 carries the rounding of inputs whose spread
the variance gives).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.jit import to_static
from paddle_tpu.nn import initializer as JI
from paddle_tpu.vision import models as jmodels

from paddle_tpu_torch import jit
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.vision import models as tmodels

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

OUT_RTOL = 1e-4
TRAIN_RTOL = 5e-3

# constructor -> input size; in the order of the reference's __init__
CONSTRUCTORS = {
    "resnet18": 64, "resnet34": 64, "resnet50": 64, "resnet101": 64,
    "resnet152": 64, "wide_resnet50_2": 64, "wide_resnet101_2": 64,
    "resnext50_32x4d": 64, "resnext50_64x4d": 64, "resnext101_32x4d": 64,
    "resnext101_64x4d": 64, "resnext152_32x4d": 64, "resnext152_64x4d": 64,
    "LeNet": 28, "vgg11": 64, "vgg13": 64, "vgg16": 64, "vgg19": 64,
    "vgg11_bn": 64, "vgg19_bn": 64, "mobilenet_v1": 64, "mobilenet_v2": 64,
    "mobilenet_v3_small": 64, "mobilenet_v3_large": 64, "alexnet": 64,
    "densenet121": 64, "densenet161": 64, "densenet169": 64,
    "densenet201": 64, "densenet264": 64, "googlenet": 224,
    "inception_v3": 299, "shufflenet_v2_x0_25": 64,
    "shufflenet_v2_x0_33": 64, "shufflenet_v2_x0_5": 64,
    "shufflenet_v2_x1_0": 64, "shufflenet_v2_x1_5": 64,
    "shufflenet_v2_x2_0": 64, "shufflenet_v2_swish": 64,
    "squeezenet1_0": 64, "squeezenet1_1": 64,
}


def _build(module, name, **kw):
    if name.endswith("_bn"):
        return getattr(module, name[:-3])(num_classes=10, batch_norm=True,
                                          **kw)
    return getattr(module, name)(num_classes=10, **kw)


def _outputs(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [o.detach().numpy() if isinstance(o, torch.Tensor)
            else np.asarray(o._value) for o in outs]


def _assert_close(got, want, what, rtol=OUT_RTOL):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, (what, g.shape, w.shape)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rtol * float(np.abs(w).max()), err_msg=what)


def _no_dropout(model):
    for m in (model.sublayers() if hasattr(model, "sublayers")
              else model.modules()):
        if type(m).__name__ == "Dropout":
            m.p = 0.0


def _pair(name):
    """The port's model from seed 0 (the reference's initializers) and the
    JAX model built with constant initializers (cheap: the reference's
    random initializers compile once for every parameter shape, ~40 s for
    Inception-v3 on a CPU) and given the port's draws; then the JAX
    model's parameters and buffers carried into the port by `convert`."""
    tm = _build(tmodels, name, device="cpu")
    JI.set_global_initializer(JI.Constant(0.0), JI.Constant(0.0))
    try:
        jm = _build(jmodels, name)
    finally:
        JI.set_global_initializer(None, None)
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    state = tm.state_dict()
    for n, t in list(jm.named_parameters()) + list(jm.named_buffers()):
        # a copy: on the CPU jnp.asarray of a numpy view aliases the torch
        # memory, which the port's training forward then moves in place
        v = np.array(state[n].numpy())
        t._value = jnp.asarray(v.T if n in linear else v)
    arrays = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    assert [n for n, _ in tm.named_parameters()] == list(arrays)
    buffers = {n: np.asarray(b._value) for n, b in jm.named_buffers()}
    with torch.no_grad():
        for p in tm.parameters():
            p.zero_()
    load_jax_state(tm, {**arrays, **buffers})
    return jm, tm, buffers


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructor_matches_jax(name):
    """The JAX side runs its forward whole, through `jit.to_static` (one
    XLA program for each mode, rather than a compile for every op shape)."""
    size = CONSTRUCTORS[name]
    jm, tm, buffers = _pair(name)
    jforward = to_static(jm)
    channels = 1 if name == "LeNet" else 3
    x = np.random.default_rng(1).standard_normal(
        (2, channels, size, size)).astype(np.float32)
    jm.eval()
    tm.eval()
    with torch.no_grad():
        got = _outputs(tm(torch.from_numpy(x)))
    _assert_close(got, _outputs(jforward(paddle.to_tensor(x))),
                  f"{name} eval")
    assert len(got) == (3 if name == "googlenet" else 1)
    jm.train()
    tm.train()
    _no_dropout(jm)
    _no_dropout(tm)
    with torch.no_grad():
        got = _outputs(tm(torch.from_numpy(x)))
    _assert_close(got, _outputs(jforward(paddle.to_tensor(x))),
                  f"{name} train", TRAIN_RTOL)
    jbuffers = {n: np.asarray(b._value) for n, b in jm.named_buffers()}
    tbuffers = {n: b.numpy() for n, b in tm.named_buffers()}
    assert sorted(tbuffers) == sorted(jbuffers)
    for n, want in jbuffers.items():
        # a mean carries the rounding of inputs whose spread its layer's
        # variance gives: the bound scales with that, not with the mean
        ref = jbuffers[n[:-len("_mean")] + "_variance"] ** 0.5 \
            if n.endswith("_mean") else want
        np.testing.assert_allclose(
            tbuffers[n], want, rtol=0,
            atol=TRAIN_RTOL * float(np.abs(ref).max()), err_msg=n)
        assert not np.array_equal(want, buffers[n]), n


@pytest.mark.parametrize("name", ["resnet50", "vgg16", "googlenet"])
def test_pretrained_and_default_device(name):
    with pytest.raises(NotImplementedError, match="pretrained"):
        getattr(tmodels, name)(pretrained=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(tmodels, name)()


def test_seed_draws_the_weights():
    a = tmodels.resnet18(device="cpu", seed=3)
    b = tmodels.resnet18(device="cpu", seed=3)
    c = tmodels.resnet18(device="cpu", seed=4)
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(pa, pb), n
        if n.endswith("conv1.weight"):
            assert not torch.equal(pa, pc), n


def test_jit_save_load_of_the_eval_resnet(tmp_path):
    """`jit.save` / `jit.load` of an evaluating ResNet-18: the loaded
    program's logits bit for bit with the eager model's, the running
    statistics inside the program."""
    model = tmodels.resnet18(num_classes=10, device="cpu", seed=5)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    model.train()
    with torch.no_grad():
        model(x)                      # running statistics off their init
    model.eval()
    path = jit.save(model, str(tmp_path / "resnet18"),
                    input_spec=[jit.InputSpec((2, 3, 32, 32), "float32")])
    layer = jit.load(path)
    with torch.no_grad():
        want = model(x)
    assert torch.equal(layer(x), want)
