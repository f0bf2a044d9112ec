"""Port parity: `paddle_tpu_torch.vision.models` ViT vs the JAX package's
(`paddle_tpu/vision/models/vit.py`), the reference's config 5 at a tiny
size.

A tiny ViT (image 32, patch 8: 16 patches and the class token, E 128,
depth 2, 2 heads of 64, MLP 512, 10 classes, fp32, dropout 0), fused and
unfused, built by the JAX package from a seed and carried across by
`convert`:

  * eval logits (and the image gradient) against the JAX model's; each
    block's attention takes the port's flash route (head_dim 64,
    non-causal, 17 tokens: no multiple of a tile), the kernels' twins on
    the CPU;
  * the fused model against the unfused one with the unfused weights
    mapped into the fused layout (the port's mirror of
    tests/test_vision_models.py:86-124);
  * 5 `TrainStep` steps (config 5's AdamW(1e-4, multi_precision),
    cross-entropy, ``donate="all"``) against the JAX `TrainStep` from the
    same weights and batch: the loss trajectory and the final parameters;
  * `flops_per_image` and the constructors' depths and widths equal to
    the reference's; ``pretrained=True`` and the default device raise;
  * `jit.save` / `jit.load` of the eval model: the loaded program's logits
    bit for bit with the eager model's.

Tolerances, fp32: logits and gradients 1e-5 absolute and relative (the
same sums in another order); fused against unfused 1e-5 (the same
products, one qkv product against three); losses 1e-5 and parameters 1e-5
absolute after 5 steps (an Adam step moves an element by about lr =
1e-4, so a skipped or mis-signed update fails), except that an element
whose gradient is within rounding of 0 may step the other way, by at most
2 lr a step, and such elements may make up at most 1e-4 of all, as
`chip_smoke.py`'s train parity holds GPT; the key biases, whose gradient
is 0 but for rounding (the softmax cancels them), are held to Adam's
bound of lr a step on each side.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.vision import models as jmodels

import paddle_tpu_torch.vision as tvision
from paddle_tpu_torch import jit
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import attention as tattention
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.vision import models as tmodels

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = 1e-5
TINY = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
            num_classes=10, dropout=0.0, attention_dropout=0.0)
LR = 1e-4
STEPS = 5
# an element whose gradient is within rounding of 0 may step the other way
# on one side, by at most 2 lr a step; such elements may make up at most
# FLIP_SHARE of all (chip_smoke.py's train parity rule)
FLIP_ATOL = 2 * LR * STEPS
FLIP_SHARE = 1e-4


def _linear_weights(tm):
    return {f"{n}.weight" for n, m in tm.named_modules()
            if isinstance(m, torch.nn.Linear)}


def _pair(fused, **cfg):
    paddle.seed(0)
    cfg = {**TINY, **cfg}
    jm = jmodels.VisionTransformer(use_fused_attn=fused, **cfg)
    tm = tmodels.VisionTransformer(use_fused_attn=fused, device="cpu", **cfg)
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    return jm, tm


def _images(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 3, 32, 32)) \
        .astype(np.float32)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_logits_and_image_gradient_match_jax(fused, monkeypatch):
    jm, tm = _pair(fused)
    jm.eval()
    tm.eval()
    routes = []
    real = tattention.FlashAttention.apply
    monkeypatch.setattr(tattention.FlashAttention, "apply",
                        lambda *a: routes.append(a) or real(*a))
    x = _images()
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.tensor(x, requires_grad=True)
    jout, tout = jm(jx), tm(tx)
    assert tuple(tout.shape) == (2, 10)
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), **TOL)
    w = np.random.default_rng(7).standard_normal((2, 10)).astype(np.float32)
    (jout * paddle.to_tensor(w)).sum().backward()
    (tout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL)
    # every block through the flash Function, non-causal, at 17 tokens
    assert len(routes) == TINY["depth"]
    assert all(a[3] is False and a[0].shape[1] == 17 for a in routes)


def _map_unfused_into_fused(fused, plain):
    """The unfused model's weights in the fused layout (q/k/v stacked into
    ``[3, H, D, E]``; the port's Linear weights are ``[out, in]``, the
    fused ones ``[in, out]``)."""
    h = TINY["num_heads"]
    d = TINY["embed_dim"] // h
    with torch.no_grad():
        for dst, src in [(fused.patch_embed.proj, plain.patch_embed.proj),
                         (fused.norm, plain.norm), (fused.head, plain.head)]:
            dst.weight.copy_(src.weight)
            dst.bias.copy_(src.bias)
        fused.cls_token.copy_(plain.cls_token)
        fused.pos_embed.copy_(plain.pos_embed)
        for fb, pb in zip(fused.blocks, plain.blocks):
            at, ff, sa = fb.fused_attn, fb.ffn, pb.self_attn
            projs = (sa.q_proj, sa.k_proj, sa.v_proj)
            at.qkv_weight.copy_(torch.stack(
                [lin.weight.reshape(h, d, -1) for lin in projs]))
            at.qkv_bias.copy_(torch.stack(
                [lin.bias.reshape(h, d) for lin in projs]))
            at.linear_weight.copy_(sa.out_proj.weight.t())
            at.linear_bias.copy_(sa.out_proj.bias)
            at.pre_ln_scale.copy_(pb.norm1.weight)
            at.pre_ln_bias.copy_(pb.norm1.bias)
            ff.ln1_scale.copy_(pb.norm2.weight)
            ff.ln1_bias.copy_(pb.norm2.bias)
            ff.linear1_weight.copy_(pb.linear1.weight.t())
            ff.linear1_bias.copy_(pb.linear1.bias)
            ff.linear2_weight.copy_(pb.linear2.weight.t())
            ff.linear2_bias.copy_(pb.linear2.bias)


def test_fused_matches_unfused_with_mapped_weights():
    fused = tmodels.VisionTransformer(use_fused_attn=True, device="cpu",
                                      seed=1, **TINY).eval()
    plain = tmodels.VisionTransformer(use_fused_attn=False, device="cpu",
                                      seed=2, **TINY).eval()
    x = torch.from_numpy(_images(seed=3))
    with torch.no_grad():
        before = fused(x)
        _map_unfused_into_fused(fused, plain)
        got, want = fused(x), plain(x)
    assert not torch.allclose(before, want, **TOL)
    torch.testing.assert_close(got, want, **TOL)


def _key_bias(name):
    """The index (along axis 0) of the key bias in parameter `name`, or
    None: row 1 of the fused ``qkv_bias [3, H, D]``, all of an unfused
    ``k_proj.bias``."""
    if name.endswith("qkv_bias"):
        return [1]
    if name.endswith("k_proj.bias"):
        return slice(None)
    return None


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_train_step_matches_jax(fused):
    jm, tm = _pair(fused)
    init = {n: np.asarray(p._value).copy() for n, p in jm.named_parameters()}
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters(),
                                  multi_precision=True)
    topt = AdamW(learning_rate=LR, parameters=tm.parameters(),
                 multi_precision=True)
    jstep = JTrainStep(jm, lambda o, y: JF.cross_entropy(o, y), jopt,
                       donate="all")
    tstep = TrainStep(tm, lambda o, y: TF.cross_entropy(o, y), topt,
                      donate="all")
    rng = np.random.default_rng(4)
    x = _images(b=4, seed=5)
    y = rng.integers(0, 10, (4,)).astype(np.int64)
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    j_losses = [float(jstep(jx, jy)) for _ in range(STEPS)]
    t_losses = [float(tstep(tx, ty)) for _ in range(STEPS)]
    np.testing.assert_allclose(t_losses, j_losses, **TOL)
    assert t_losses[-1] < t_losses[0]
    linear = _linear_weights(tm)
    tparams = dict(tm.named_parameters())
    flipped = total = 0
    for name, p in jm.named_parameters():
        want = np.asarray(p._value)
        want = want.T if name in linear else want
        got = tparams[name].detach().numpy()
        kbias = _key_bias(name)
        if kbias is not None:
            # the key bias adds q . b_k to every score of a row, which
            # the softmax cancels: its gradient is 0 but for rounding, and
            # Adam scales that noise to a step of about lr in either
            # direction, on each side its own. Held to Adam's bound: at
            # most lr a step from where both started.
            start = np.asarray(init[name])
            for side in (got, want):
                moved = np.abs(side[kbias] - start[kbias])
                assert moved.max() <= STEPS * LR * (1 + 1e-3), name
            got, want = np.delete(got, kbias, 0), np.delete(want, kbias, 0)
        diff = np.abs(got - want)
        assert diff.max(initial=0.0) <= FLIP_ATOL, name
        flipped += int((diff > PARAM_ATOL).sum())
        total += diff.size
    assert flipped <= FLIP_SHARE * total, (flipped, total)


@pytest.mark.parametrize("cfg", [
    dict(TINY),
    dict(TINY, num_classes=0),
    # ViT-L/16's width and image at depth 1 (the count is linear in depth)
    dict(img_size=224, patch_size=16, embed_dim=1024, depth=1, num_heads=16,
         num_classes=1000)], ids=["tiny", "headless", "vit_l_16_width"])
@pytest.mark.parametrize("training", [True, False])
def test_flops_per_image_is_the_reference_count(cfg, training):
    paddle.seed(0)
    want = jmodels.VisionTransformer(**cfg).flops_per_image(training)
    got = tmodels.VisionTransformer(device="cpu", **cfg) \
        .flops_per_image(training)
    assert got == want


@pytest.mark.parametrize("name", ["vit_b_16", "vit_l_16", "vit_l_32"])
def test_constructors_build_the_reference_configuration(name, monkeypatch):
    """Each constructor passes the reference's configuration (depth,
    width, heads, patch) and the caller's overrides to VisionTransformer;
    recorded on both sides without building the full model."""
    seen = {}
    for mod, key in ((jmodels.vit, "jax"), (tmodels.vit, "port")):
        monkeypatch.setattr(mod, "VisionTransformer",
                            lambda key=key, **kw: seen.setdefault(key, kw))
    getattr(jmodels.vit, name)(num_classes=10, img_size=64)
    getattr(tmodels.vit, name)(num_classes=10, img_size=64)
    assert seen["port"] == seen["jax"]
    assert seen["port"]["depth"] == (12 if name == "vit_b_16" else 24)
    assert seen["port"]["embed_dim"] == (768 if name == "vit_b_16" else 1024)


def test_pretrained_raises_the_reference_message():
    with pytest.raises(ValueError) as jerr:
        jmodels.vit_l_16(pretrained=True)
    with pytest.raises(ValueError) as terr:
        tmodels.vit_l_16(pretrained=True, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_exports():
    for name in ("VisionTransformer", "vit_b_16", "vit_l_16", "vit_l_32"):
        assert getattr(tvision, name) is getattr(tmodels, name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_default_device_is_the_card(fused):
    m = tmodels.VisionTransformer(use_fused_attn=fused, device="cpu", **TINY)
    assert {p.device.type for p in m.parameters()} == {"cpu"}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodels.VisionTransformer(use_fused_attn=fused, **TINY)


def test_seed_makes_the_weights():
    a = tmodels.VisionTransformer(device="cpu", seed=3, **TINY)
    b = tmodels.VisionTransformer(device="cpu", seed=3, **TINY)
    c = tmodels.VisionTransformer(device="cpu", seed=4, **TINY)
    for (n, p), q, r in zip(a.named_parameters(), b.parameters(),
                            c.parameters()):
        assert torch.equal(p, q), n
    assert not torch.equal(a.pos_embed, c.pos_embed)
    # the class token and positions are truncated at 2 std of 0.02
    assert float(a.pos_embed.abs().max()) <= 0.04


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_jit_save_load_is_bit_for_bit(fused, tmp_path):
    _, tm = _pair(fused)
    tm.eval()
    path = jit.save(tm, tmp_path / "vit",
                    input_spec=[jit.InputSpec([2, 3, 32, 32])])
    loaded = jit.load(path)
    assert loaded.has_forward
    x = torch.from_numpy(_images(seed=6))
    with torch.no_grad():
        want = tm(x)
    got = loaded(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
