"""The port's `framework.io.async_save`: `save`'s writer on a thread.

Mirrors `tests/test_async_save.py` on the port: a round trip, a nested
object polled to completion, a flipped byte caught by the CRC, a failed
write raised from `wait()`. The reference's `test_legacy_files_still_load`
(files of its plain `save`, which had no trailer) has no counterpart: every
file the port's `save` ever wrote carries the trailer, and `load` reads an
`async_save`d file as it reads a `save`d one (checked byte for byte below).
Besides: the object is snapshotted when the call returns, a handle dropped
unwaited still finishes its file, concurrent writers to one path leave one
intact file, and the same states (weights carried by `convert.py`) and the
same failure go through the JAX package's `async_save` and the port's with
equal loaded tensors and the reference's failure message.
"""
from __future__ import annotations

import gc
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.framework import io as jio
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM

from paddle_tpu_torch.convert import jax_state_values, load_jax_state
from paddle_tpu_torch.framework.io import (CheckpointCorruptError,
                                           async_save, load, save)
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM

GPT_CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128,
               max_position_embeddings=64, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)


def _linear(seed=0):
    """A port Linear(16, 8) with weights drawn by numpy from `seed`."""
    rng = np.random.default_rng(seed)
    layer = torch.nn.Linear(16, 8)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(
            rng.standard_normal((8, 16)).astype(np.float32)))
        layer.bias.copy_(torch.from_numpy(
            rng.standard_normal(8).astype(np.float32)))
    return layer


def test_async_save_roundtrip(tmp_path):
    model = _linear()
    p = tmp_path / "m.pdparams"
    h = async_save(model.state_dict(), p)
    h.wait()
    assert h.done()
    sd = load(p)
    torch.testing.assert_close(sd["weight"], model.weight.detach(),
                               rtol=0, atol=0)
    torch.testing.assert_close(sd["bias"], model.bias.detach(), rtol=0,
                               atol=0)


def test_async_save_nested_and_poll(tmp_path):
    obj = {"model": _linear(1).state_dict(), "step": 42, "lr": 0.1,
           "history": [1.0, 2.0]}
    p = tmp_path / "ckpt.pd"
    h = async_save(obj, p)
    for _ in range(100000):
        if h.done():
            break
    h.wait()
    out = load(p)
    assert out["step"] == 42 and out["history"] == [1.0, 2.0]
    assert sorted(out["model"]) == ["bias", "weight"]


def test_async_file_is_save_file(tmp_path):
    """The writer thread writes `save`'s format: the same bytes."""
    obj = {"w": torch.arange(1000, dtype=torch.float32), "n": 3}
    save(obj, tmp_path / "sync.pt")
    async_save(obj, tmp_path / "async.pt").wait()
    assert (tmp_path / "async.pt").read_bytes() == \
        (tmp_path / "sync.pt").read_bytes()


def test_corrupt_file_detected(tmp_path):
    p = tmp_path / "c.pdparams"
    async_save({"x": torch.ones(64)}, p).wait()
    # flip a payload byte: the CRC must catch it
    with open(p, "r+b") as f:
        f.seek(30)
        b = f.read(1)
        f.seek(30)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError, match="CRC"):
        load(p)
    with pytest.raises(CheckpointCorruptError):
        load(p)


def test_async_save_failure_surfaces(tmp_path):
    # the target is a directory: the writer cannot rename onto it
    target = tmp_path / "iam_a_dir"
    target.mkdir()
    h = async_save({"x": 1}, target)
    with pytest.raises(IOError, match="failed: rename failed"):
        h.wait()
    assert h.done()
    assert list(tmp_path.iterdir()) == [target]   # no temporary file left


def test_object_is_snapshotted_when_the_call_returns(tmp_path):
    t = torch.zeros(1 << 16)
    h = async_save({"t": t}, tmp_path / "s.pt")
    t.fill_(7.0)
    h.wait()
    assert float(load(tmp_path / "s.pt")["t"].abs().max()) == 0.0


def test_unwaited_handle_finishes_its_file(tmp_path):
    h = async_save({"t": torch.ones(8)}, tmp_path / "d.pt")
    del h
    gc.collect()
    torch.testing.assert_close(load(tmp_path / "d.pt")["t"], torch.ones(8))


def test_concurrent_writers_to_one_path(tmp_path):
    """Eight threads save eight objects to one path at once: every write
    succeeds, the file left is one of them, intact."""
    p = tmp_path / "same.pt"
    objs = [{"i": i, "t": torch.full((4096,), float(i))} for i in range(8)]
    handles, errors = [None] * 8, []

    def run(i):
        try:
            handles[i] = async_save(objs[i], p)
        except Exception as e:      # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert errors == []
    for h in handles:
        h.wait()
    out = load(p)
    torch.testing.assert_close(out["t"], objs[out["i"]]["t"])
    assert [q.name for q in tmp_path.iterdir()] == ["same.pt"]


def _linear_pair(seed):
    """A JAX Linear(16, 8) with weights drawn by numpy from `seed`, and
    the port's carried from it."""
    jm = jnn.Linear(16, 8)
    rng = np.random.default_rng(seed)
    for _, p in jm.named_parameters():
        p.set_value(rng.standard_normal(p.shape).astype(np.float32))
    tm = torch.nn.Linear(16, 8)
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    return jm, tm


def _gpt_pair(seed):
    paddle.seed(seed)
    jm = JGPTForCausalLM(JGPTConfig(**GPT_CFG))
    tm = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    return jm, tm


def _as_numpy(v):
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


@pytest.mark.parametrize("case", ["linear", "nested", "gpt"])
def test_loaded_state_matches_reference(tmp_path, case):
    """One state saved by the JAX package's `async_save` and by the
    port's: every parameter loads back equal (Linear weights in each
    package's layout), and so do the plain values beside them."""
    jm, tm = (_gpt_pair if case == "gpt" else _linear_pair)(3)
    extra = {"step": 42, "lr": 0.1, "history": [1.0, 2.0]} \
        if case == "nested" else {}
    jpath, tpath = str(tmp_path / "ref.pd"), str(tmp_path / "port.pd")
    jio.async_save({"model": jm.state_dict(), **extra}, jpath).wait()
    async_save({"model": tm.state_dict(), **extra}, tpath).wait()
    ref, out = jio.load(jpath), load(tpath)
    assert {k: v for k, v in out.items() if k != "model"} == \
        {k: v for k, v in ref.items() if k != "model"}
    names = [n for n, _ in tm.named_parameters()]
    expected = jax_state_values(
        tm, {n: _as_numpy(ref["model"][n]) for n in names})
    for name, want in zip(names, expected):
        np.testing.assert_array_equal(out["model"][name].numpy(), want,
                                      err_msg=name)


def test_failure_message_matches_reference(tmp_path):
    """A target that is a directory fails both writers at the rename:
    the port's `wait()` raises the reference's message, then the OS's."""
    target = tmp_path / "iam_a_dir"
    target.mkdir()
    with pytest.raises(IOError) as ref:
        jio.async_save({"x": 1}, str(target)).wait()
    with pytest.raises(IOError) as port:
        async_save({"x": 1}, str(target)).wait()
    assert str(ref.value) == f"async_save to {target} failed: rename failed"
    assert str(port.value).startswith(str(ref.value) + " (")
