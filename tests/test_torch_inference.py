"""Port parity: the `inference` Predictor over `jit.save` artifacts against
the JAX package's.

Mirrors tests/test_inference_launch.py (the run and handle styles over a
saved `Sequential`) and tests/test_gpt.py's decode-step round trip (a
`GPTDecodeStep` saved with `jit.save`, served by a Predictor in a greedy
token loop): the same weights (`convert.load_jax_state`) and numpy inputs
through both packages. The config is tiny (vocab 128, hidden 64, 2 layers,
4 heads). The predictors run on the CPU (``Config(path,
device="cpu")``): the port's Config means the card by default.

Tolerance: rtol 1e-5 and atol 1e-6 for the net's fp32 outputs (the same
products summed in another order by XLA and PyTorch); tokens exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinf
from paddle_tpu import jit as jjit
from paddle_tpu.incubate.models import GPTDecodeStep as JGPTDecodeStep

from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.incubate.models import GPTDecodeStep

from test_torch_jit_save import TOL, gpt_pair, mlp_pair


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal((2, 4)) \
        .astype(np.float32)


def _mlp_predictors(tmp_path):
    jm, tm = mlp_pair()
    jjit.save(jm, str(tmp_path / "j.pdmodel"),
              input_spec=[jjit.InputSpec([2, 4], "float32")])
    jit.save(tm, tmp_path / "t.pdmodel",
             input_spec=[jit.InputSpec([2, 4], "float32")])
    jcfg = jinf.Config(str(tmp_path / "j.pdmodel"))
    tcfg = inference.Config(str(tmp_path / "t.pdmodel"), device="cpu")
    tcfg.enable_memory_optim()
    return jinf.create_predictor(jcfg), inference.create_predictor(tcfg), tm


def test_predictor_run_styles_match_reference(tmp_path):
    jpred, tpred, tm = _mlp_predictors(tmp_path)
    x = _x()
    want = jpred.run([x])[0]
    # direct style
    outs = tpred.run([x])
    assert len(outs) == 1 and isinstance(outs[0], np.ndarray)
    np.testing.assert_allclose(outs[0], want, **TOL)
    with torch.no_grad():
        np.testing.assert_array_equal(outs[0],
                                      tm(torch.from_numpy(x)).numpy())
    # handle style
    names = tpred.get_input_names()
    assert names == jpred.get_input_names()
    h = tpred.get_input_handle(names[0])
    h.copy_from_cpu(x)
    assert tpred.run() is None
    out_h = tpred.get_output_handle(tpred.get_output_names()[0])
    assert out_h.shape() == [2, 2] and out_h.type() == "float32"
    np.testing.assert_allclose(out_h.copy_to_cpu(), want, **TOL)
    # a second predictor of the config computes the same
    np.testing.assert_array_equal(tpred.clone().run([x])[0], outs[0])


def test_predictor_pool(tmp_path):
    _, tpred, _ = _mlp_predictors(tmp_path)
    cfg = inference.Config(str(tmp_path / "t.pdmodel"), device="cpu")
    pool = inference.PredictorPool(cfg, size=3)
    assert pool.size() == 3
    assert pool.retrive(1) is pool.retrieve(1)
    assert pool.retrive(0) is not pool.retrive(2)
    x = _x(1)
    for i in range(3):
        np.testing.assert_array_equal(pool.retrive(i).run([x])[0],
                                      tpred.run([x])[0])


def test_data_types_and_versions_match_reference():
    for name in ("FLOAT32", "INT64", "INT32", "UINT8", "INT8", "FLOAT16",
                 "BFLOAT16"):
        code = getattr(inference.DataType, name)
        assert code == getattr(jinf.DataType, name)
        assert inference.get_num_bytes_of_data_type(code) == \
            jinf.get_num_bytes_of_data_type(code)
    assert inference.get_version() == jinf.get_version()
    assert inference.get_trt_compile_version() == (0, 0, 0)
    assert inference.get_trt_runtime_version() == (0, 0, 0)


def test_convert_to_mixed_precision_raises():
    with pytest.raises(NotImplementedError, match="before jit.save"):
        inference.convert_to_mixed_precision("a", "b", "c", "d")


def test_predictor_refuses_an_artifact_without_forward(tmp_path):
    _, tm = mlp_pair()
    jit.save(tm, tmp_path / "w")
    with pytest.raises(ValueError, match="no compiled forward"):
        inference.create_predictor(inference.Config(
            str(tmp_path / "w.pdmodel"), device="cpu"))


def test_bfloat16_program_handles_raise(tmp_path):
    """numpy has no bfloat16: the handles say so; `jit.load`'s layer runs
    the program on tensors."""
    _, tm = mlp_pair()
    tm = tm.to(torch.bfloat16)
    jit.save(tm, tmp_path / "b", input_spec=[jit.InputSpec([2, 4],
                                                           "bfloat16")])
    pred = inference.create_predictor(inference.Config(
        str(tmp_path / "b.pdmodel"), device="cpu"))
    with pytest.raises(TypeError, match="bfloat16"):
        pred.get_input_handle("x0").copy_from_cpu(_x())
    with pytest.raises(TypeError, match="bfloat16"):
        pred.run([_x()])
    x = torch.from_numpy(_x()).to(torch.bfloat16)
    with torch.no_grad():
        torch.testing.assert_close(jit.load(tmp_path / "b")(x), tm(x),
                                   rtol=0, atol=0)


def test_decode_step_predictor_tokens_match_reference_and_generate(tmp_path):
    """tests/test_gpt.py::test_decode_step_predictor_roundtrip on both
    packages: the prompt prefilled eagerly through the dynamic cache, its
    K/V packed into static buffers, then N - 1 tokens through each
    package's Predictor over its saved GPTDecodeStep. The port's tokens
    equal the JAX Predictor's and the port's `generate`'s."""
    jm, tm = gpt_pair()
    cfg = tm.config
    B, P, N = 2, 4, 5
    T = P + N
    L, H = cfg.num_hidden_layers, cfg.num_attention_heads
    D = cfg.hidden_size // H
    ids = np.random.default_rng(0).integers(0, 128, (B, P)).astype(np.int64)
    specs = [([B, 1], "int64"), ([L, B, T, H, D], "float32"),
             ([L, B, T, H, D], "float32"), ([], "int32")]
    jjit.save(JGPTDecodeStep(jm), str(tmp_path / "j"),
              input_spec=[jjit.InputSpec(*s) for s in specs])
    jit.save(GPTDecodeStep(tm), tmp_path / "t",
             input_spec=[jit.InputSpec(*s) for s in specs])
    # the static-cache step's host scalars (sqrt(head_dim), the mask
    # value) are no tensor constants of the program
    assert not jit.load(tmp_path / "t").program.constants
    jpred = jinf.create_predictor(jinf.Config(str(tmp_path / "j")))
    tpred = inference.create_predictor(inference.Config(
        str(tmp_path / "t.pdmodel"), device="cpu"))

    def prefill_jax():
        caches = jm.gen_caches(batch_size=B)
        logits, caches = jm(paddle.to_tensor(ids), caches=caches)
        kv = [(np.asarray(k._value), np.asarray(v._value))
              for k, v in caches]
        return np.asarray(logits._value), kv

    def prefill_port():
        with torch.no_grad():
            logits, caches = tm(torch.from_numpy(ids),
                                caches=tm.gen_caches(B))
        return logits.numpy(), [(k.numpy(), v.numpy()) for k, v in caches]

    def loop(pred, prefill):
        logits, kv = prefill()
        kb = np.zeros((L, B, T, H, D), np.float32)
        vb = np.zeros((L, B, T, H, D), np.float32)
        for layer, (k, v) in enumerate(kv):
            kb[layer, :, :P] = k
            vb[layer, :, :P] = v
        tok = np.argmax(logits[:, -1, :], -1)
        got = [tok]
        for i in range(N - 1):
            lg, kb, vb = pred.run([tok[:, None].astype(np.int64), kb, vb,
                                   np.asarray(P + i, np.int32)])
            tok = np.argmax(lg[:, -1, :], -1)
            got.append(tok)
        return np.stack(got, 1)

    want = loop(jpred, prefill_jax)
    got = loop(tpred, prefill_port)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tm.generate(torch.from_numpy(ids), max_new_tokens=N).numpy())
