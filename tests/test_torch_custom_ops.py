"""The flash forward and the fused LayerNorm as `torch.library` ops, so that
`torch.export` (and with it `jit.save`) keeps the hand-written kernels in a
saved program.

- `torch.library.opcheck` holds both ops' schema, fake (the outputs'
  shapes, dtypes and strides against the CPU kernel's), autograd
  registration and AOT dispatch on the CPU, fp32 and bf16, with q, k, v the
  strided views of one fused projection as the model hands them over.
- An exported tiny GPT forward (1 head of 64: the flash route) and an
  exported `FusedBiasDropoutResidualLayerNorm` show the
  ``paddle_tpu_torch::`` nodes and replay equal to eager, and the layer
  to the JAX package's on the same weights (rtol 1e-5, atol 1e-5, as in
  tests/test_torch_fused_ln.py).
- Exported on fake CUDA tensors (a trace needs no card), the flash op's
  fake stands in and nothing of its twin is traced; a kernel wrapper that
  is no op raises instead of tracing anything.
- Under the strict numeric checks the op is checked under its name.
- `inference.Config()` raises where no card exists.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import \
    FusedBiasDropoutResidualLayerNorm as JLayer

from paddle_tpu_torch import inference
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework import set_flags
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.incubate.nn import FusedBiasDropoutResidualLayerNorm
from paddle_tpu_torch.kernels import cross_entropy, flash_attention, fused_ln
from paddle_tpu_torch.nn import functional as F

DTYPES = [torch.float32, torch.bfloat16]


def _fused_qkv(b, n, h, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, d))
                           .astype(np.float32)).to(dtype)
    return qkv.unbind(2)


def _ln_args(r, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for shape in ((r, d), (r, d), (d,), (d,), (d,))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_opcheck_flash_attention_fwd(dtype, causal):
    q, k, v = _fused_qkv(2, 16, 2, 64, dtype)
    torch.library.opcheck(flash_attention.flash_attention_fwd_op,
                          (q, k, v, causal, 0.125))
    out, lse = flash_attention.flash_attention_fwd_op(q, k, v, causal, 0.125)
    want_out, want_lse = flash_attention.flash_attention_reference(
        q, k, v, causal, 0.125)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert out.is_contiguous() and lse.dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_opcheck_fused_ln_fwd(dtype):
    args = _ln_args(8, 128, dtype)
    torch.library.opcheck(fused_ln.fused_ln_fwd_op, (*args, 1e-5))
    assert torch.equal(fused_ln.fused_ln_fwd_op(*args, 1e-5),
                       fused_ln.fused_ln_reference(*args, 1e-5))


def _tiny_gpt():
    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=1, intermediate_size=128,
                    max_position_embeddings=64, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    return GPTForCausalLM(cfg, device="cpu", seed=0).eval()


def _targets(program):
    return [str(node.target) for node in program.graph.nodes
            if node.op == "call_function"]


def test_exported_gpt_keeps_the_flash_op():
    model = _tiny_gpt()
    ids = torch.from_numpy(np.random.default_rng(0)
                           .integers(0, 128, (2, 16)))
    with torch.no_grad():
        program = torch.export.export(model, (ids,))
        want = model(ids)
    targets = _targets(program)
    assert targets.count("paddle_tpu_torch.flash_attention_fwd.default") \
        == 2, targets
    # the twin's own ops are not in the program
    assert not any("logsumexp" in t for t in targets), targets
    with torch.no_grad():
        torch.testing.assert_close(program.module()(ids), want, rtol=0,
                                   atol=0)


def test_exported_fused_ln_layer_keeps_the_op():
    d = 128
    paddle.seed(d)
    jl = JLayer(d, dropout_rate=0.0)
    jl.eval()
    rng = np.random.default_rng(d)
    for _, p in jl.named_parameters():
        p.set_value(rng.standard_normal(p.shape).astype(np.float32))
    tl = FusedBiasDropoutResidualLayerNorm(d, dropout_rate=0.0,
                                           device="cpu").eval()
    load_jax_state(tl, {n: np.asarray(p._value)
                        for n, p in jl.named_parameters()})
    x, res = (rng.standard_normal((2, 5, d)).astype(np.float32)
              for _ in range(2))
    xt, rt = torch.from_numpy(x), torch.from_numpy(res)
    with torch.no_grad():
        program = torch.export.export(tl, (xt, rt))
        eager = tl(xt, rt)
        got = program.module()(xt, rt)
    assert "paddle_tpu_torch.fused_ln_fwd.default" in _targets(program)
    torch.testing.assert_close(got, eager, rtol=0, atol=0)
    want = jl(paddle.to_tensor(x), paddle.to_tensor(res)).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


class _Attention(torch.nn.Module):
    def forward(self, q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              training=False)


class _CrossEntropy(torch.nn.Module):
    def forward(self, logits, labels):
        return cross_entropy.cross_entropy_fwd(logits, labels)[0]


def test_export_on_cuda_tensors_never_traces_a_twin():
    """A trace of CUDA tensors (fake ones: no card is needed) takes the
    flash op's fake; the cross-entropy wrapper, no op, raises."""
    with FakeTensorMode() as mode:
        q, k, v = (torch.empty(1, 8, 1, 64, device="cuda") for _ in range(3))
        logits = torch.empty(4, 8192, device="cuda")
        labels = torch.zeros(4, dtype=torch.long, device="cuda")
    with torch.no_grad():
        program = torch.export.export(_Attention(), (q, k, v))
    targets = [t for t in _targets(program) if "getitem" not in t]
    assert targets == ["paddle_tpu_torch.flash_attention_fwd.default"], \
        targets
    with pytest.raises(RuntimeError, match="torch.library ops"), \
            torch.no_grad():
        torch.export.export(_CrossEntropy(), (logits, labels))
    with mode, pytest.raises(RuntimeError, match="cannot be traced"):
        flash_attention.flash_attention_fwd(q, k, v, True)


def test_strict_check_names_the_op():
    q, k, v = _fused_qkv(1, 8, 1, 64, torch.float32)
    q = q.clone()
    q[0, 0, 0, 0] = float("nan")
    set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError,
                           match="'flash_attention_fwd'"):
            flash_attention.flash_attention_fwd_op(q, k, v, True, 0.125)
    finally:
        set_flags({"FLAGS_check_nan_inf": False})


def test_config_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: Config() takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.Config()
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.Config(str(tmp_path / "m.pdmodel"))
    cfg = inference.Config(str(tmp_path / "m.pdmodel"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        cfg.enable_use_gpu(100, 0)
    assert cfg.device() == torch.device("cpu")
