"""Port parity: `paddle_tpu_torch.jit.save` / `load` against the JAX
package's `jit.save` / `load` on the same weights.

The same `Sequential(Linear, Tanh, Linear)` and a tiny `GPTForCausalLM`
(vocab 128, hidden 64, 2 layers, 4 heads: head_dim 16, the plain attention
on both sides) are built by the JAX package, their weights carried into the
port with `convert.load_jax_state`, and saved and loaded by each package.
Inputs are numpy arrays from a seed.

Tolerance: rtol 1e-5 and atol 1e-6 in fp32, the same products summed in
another order by XLA and by PyTorch (the GPT's logits as in
tests/test_torch_gpt.py, atol 1e-5).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import jit as jjit
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM

from paddle_tpu_torch import jit
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.framework.io import load
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM

TOL = dict(rtol=1e-5, atol=1e-6)
GPT_TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)


def _jax_arrays(layer):
    return {n: np.asarray(p._value) for n, p in layer.named_parameters()}


def mlp_pair(seed=0):
    """The reference test's net in both packages, the JAX weights drawn by
    numpy from `seed`."""
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 2))
    rng = np.random.default_rng(seed)
    for _, p in jm.named_parameters():
        p.set_value(rng.standard_normal(p.shape).astype(np.float32))
    tm = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                             torch.nn.Linear(8, 2))
    load_jax_state(tm, _jax_arrays(jm))
    return jm, tm


def gpt_pair(seed=0):
    paddle.seed(seed)
    jm = JGPTForCausalLM(JGPTConfig(**CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu").eval()
    load_jax_state(tm, _jax_arrays(jm))
    return jm, tm


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def test_mlp_save_load_matches_reference(tmp_path):
    jm, tm = mlp_pair()
    spec = [[2, 4], "float32"]
    jjit.save(jm, str(tmp_path / "j.pdmodel"),
              input_spec=[jjit.InputSpec(*spec)])
    jit.save(tm, tmp_path / "t.pdmodel", input_spec=[jit.InputSpec(*spec)])
    ja, ta = jjit.load(str(tmp_path / "j.pdmodel")), \
        jit.load(tmp_path / "t.pdmodel")
    assert ja.has_forward and ta.has_forward
    x = _x((2, 4))
    want = ja(x).numpy()
    got = ta(x)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(),
                                   tm(torch.from_numpy(x)).numpy(),
                                   rtol=0, atol=0)


def test_gpt_save_load_matches_reference(tmp_path):
    jm, tm = gpt_pair()
    jjit.save(jm, str(tmp_path / "j.pdmodel"),
              input_spec=[jjit.InputSpec([2, 12], "int64")])
    jit.save(tm, tmp_path / "t.pdmodel",
             input_spec=[jit.InputSpec([2, 12], "int64")])
    ids = np.random.default_rng(2).integers(0, 128, (2, 12)).astype(np.int64)
    want = jjit.load(str(tmp_path / "j.pdmodel"))(ids).numpy()
    loaded = jit.load(tmp_path / "t.pdmodel")
    got = loaded(torch.from_numpy(ids))
    assert tuple(got.shape) == (2, 12, 128)
    # host scalars (the mask value) stay Python floats: no tensor
    # constant ties the program to the device it was traced on
    assert not loaded.program.constants
    np.testing.assert_allclose(got.numpy(), want, **GPT_TOL)


@pytest.mark.parametrize("with_program", [False, True])
def test_state_dict_keys_match_reference(tmp_path, with_program):
    """The loaded weights' keys are the reference's and the layer's, read
    from the saved state dict or, with a program, from the program; the
    values are the layer's."""
    for (jm, tm), spec in ((mlp_pair(), [[3, 4], "float32"]),
                           (gpt_pair(), [[2, 12], "int64"])):
        jspec = [jjit.InputSpec(*spec)] if with_program else None
        tspec = [jit.InputSpec(*spec)] if with_program else None
        jjit.save(jm, str(tmp_path / "j"), input_spec=jspec)
        jit.save(tm, tmp_path / "t", input_spec=tspec)
        jkeys = set(jjit.load(str(tmp_path / "j")).state_dict())
        loaded = jit.load(tmp_path / "t").state_dict()
        assert set(loaded) == jkeys == set(tm.state_dict())
        for key, value in tm.state_dict().items():
            torch.testing.assert_close(loaded[key], value, rtol=0, atol=0)


def test_weights_stored_once(tmp_path):
    """With a program, the artifact keeps the weights only inside it: no
    second state dict, so a net whose weights outweigh its graph makes a
    file of about one copy of them."""
    torch.manual_seed(0)
    tm = torch.nn.Sequential(torch.nn.Linear(256, 256), torch.nn.Tanh(),
                             torch.nn.Linear(256, 256))
    path = jit.save(tm, tmp_path / "t",
                    input_spec=[jit.InputSpec([2, 256], "float32")])
    payload = load(path)
    assert "program" in payload and "state_dict" not in payload
    weights = sum(v.numel() * v.element_size()
                  for v in tm.state_dict().values())
    assert weights < (tmp_path / "t.pdmodel").stat().st_size < 1.5 * weights


def test_no_input_spec_raises_as_reference(tmp_path):
    jm, tm = mlp_pair()
    jjit.save(jm, str(tmp_path / "j"))
    path = jit.save(tm, tmp_path / "t")
    assert path == str(tmp_path / "t.pdmodel")      # the suffix rule
    ja, ta = jjit.load(str(tmp_path / "j")), jit.load(tmp_path / "t")
    assert not ja.has_forward and not ta.has_forward
    x = _x((2, 4))
    with pytest.raises(RuntimeError) as jerr:
        ja(x)
    with pytest.raises(RuntimeError) as terr:
        ta(x)
    assert str(terr.value) == str(jerr.value)
    # the weights are there all the same
    torch.testing.assert_close(ta.state_dict()["0.weight"],
                               tm.state_dict()["0.weight"])


def test_train_raises_eval_returns_self(tmp_path):
    _, tm = mlp_pair()
    jit.save(tm, tmp_path / "t", input_spec=[jit.InputSpec([2, 4])])
    ta = jit.load(tmp_path / "t")
    assert ta.eval() is ta
    with pytest.raises(RuntimeError, match="inference-only"):
        ta.train()


def test_set_state_rearms_the_program(tmp_path):
    """The program saved with one model's weights, armed with another's:
    its outputs become the other's, as the reference's set_state does."""
    jm, tm = gpt_pair(seed=0)
    jm2, tm2 = gpt_pair(seed=1)
    spec = [[2, 12], "int64"]
    jjit.save(jm, str(tmp_path / "j"), input_spec=[jjit.InputSpec(*spec)])
    jit.save(tm, tmp_path / "t", input_spec=[jit.InputSpec(*spec)])
    ja, ta = jjit.load(str(tmp_path / "j")), jit.load(tmp_path / "t")
    ja.set_state(jm2.state_dict())
    ta.set_state(tm2.state_dict())
    ids = np.random.default_rng(3).integers(0, 128, (2, 12)).astype(np.int64)
    with torch.no_grad():
        eager = tm2(torch.from_numpy(ids)).numpy()
    got = ta(ids).numpy()
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_allclose(got, ja(ids).numpy(), **GPT_TOL)
    with pytest.raises(KeyError):
        ta.set_state({"gpt.wte.weight": tm2.gpt.wte.weight})


class _DataDependent(torch.nn.Module):
    """A forward that branches on a value: `torch.export` cannot trace it."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 4)

    def forward(self, x):
        if float(x.sum()) > 0:
            return self.lin(x)
        return -x


def test_failed_export_keeps_the_weights(tmp_path):
    layer = _DataDependent()
    with pytest.warns(UserWarning, match="not exported"):
        jit.save(layer, tmp_path / "d", input_spec=[jit.InputSpec([2, 4])])
    art = jit.load(tmp_path / "d")
    assert not art.has_forward and art.export_error
    torch.testing.assert_close(art.state_dict()["lin.weight"],
                               layer.lin.weight.detach())
    with pytest.raises(RuntimeError, match="export error"):
        art(torch.ones(2, 4))


def test_loaded_program_runs_without_the_model_code(tmp_path, monkeypatch):
    """The artifact alone rebuilds the program: with the GPT classes'
    forwards made to raise, the loaded layer still computes the logits."""
    _, tm = gpt_pair()
    jit.save(tm, tmp_path / "t", input_spec=[jit.InputSpec([1, 8],
                                                           "int64")])
    ids = torch.arange(8)[None]
    with torch.no_grad():
        want = tm(ids)
    from paddle_tpu_torch.incubate.models import gpt

    def refuse(*args, **kwargs):
        raise AssertionError("model code ran")

    for cls in (gpt.GPTForCausalLM, gpt.GPTModel, gpt.GPTBlock,
                gpt.GPTAttention, gpt.GPTMLP):
        monkeypatch.setattr(cls, "forward", refuse)
    torch.testing.assert_close(jit.load(tmp_path / "t")(ids), want,
                               rtol=0, atol=0)
