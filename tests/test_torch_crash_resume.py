"""Port parity: crash-resume of the serving engine.

`paddle_tpu/serving/engine.py` `state_payload` (:1698) / `restore_state`
(:1726) and `paddle_tpu/incubate/checkpoint.py` `ServeCheckpointer` (:382):

  * a JAX engine's mid-flight `state_payload()`, through JSON, restored
    into the port's engine, finishes every stream with the JAX engine's
    uninterrupted tokens, greedy and sampled; the port's payload is the
    reference's dict (restored into a JAX engine too);
  * the port's own snapshot through `ServeCheckpointer` files (rolling
    retention, the newest intact snapshot first, a refusal when every one
    is corrupt) into a fresh engine: byte-identical streams, arrival
    order, `next_rid` and `weight_epoch` carried over, `resumed` counted;
  * refusals: ``torn_swap`` against the engine's weight CRC after a swap,
    ``adapter_mismatch`` for an unregistered tenant, ValueError for a
    request id live in the engine.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.serving import LLMEngine as JLLMEngine

from paddle_tpu_torch.convert import jax_state_values, load_jax_state
from paddle_tpu_torch.framework.io import (CheckpointCorruptError, load_json,
                                           save_json)
from paddle_tpu_torch.incubate.checkpoint import ServeCheckpointer
from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import FINISHED, LLMEngine, ServeRefusal

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

VOCAB = 128
CFG = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=1, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0, initializer_range=0.3)
ENGINE = dict(max_batch_size=2, block_size=4)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPTForCausalLM(JGPTConfig(**CFG))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    return jm, tm


def _prompt(length, seed=0):
    rng = np.random.default_rng(seed * 1000 + length)
    return rng.integers(0, VOCAB, length).tolist()


MIX = [(11, {}), (6, dict(temperature=0.9, top_k=8, seed=5)), (9, {}),
       (7, dict(temperature=1.1, top_p=0.85, seed=6))]


def _add_mix(engine, n=9):
    return [engine.add_request(_prompt(length, seed=35), max_new_tokens=n,
                               request_id=f"s{i}", **kw)
            for i, (length, kw) in enumerate(MIX)]


def _uninterrupted(make):
    engine = make()
    reqs = _add_mix(engine)
    engine.run()
    return {r.rid: r.generated for r in reqs}


def test_jax_payload_restores_into_the_port(models):
    jm, tm = models
    want = _uninterrupted(lambda: JLLMEngine(jm, **ENGINE))
    engine = JLLMEngine(jm, **ENGINE)
    _add_mix(engine)
    for _ in range(5):
        engine.step()                                 # mid-flight
    payload = json.loads(json.dumps(engine.state_payload()))
    assert payload["requests"]
    port = LLMEngine(tm, device="cpu", **ENGINE)
    restored = port.restore_state(payload)
    assert [r.rid for r in restored] == [p["rid"]
                                         for p in payload["requests"]]
    port.run()
    for r in restored:
        assert r.state == FINISHED and r.generated == want[r.rid]
    assert port.stats()["resumed"] == len(restored)
    assert port.add_request([1, 2], 1).rid == f"r{payload['next_rid']}"


def test_port_payload_is_the_reference_dict(models):
    """The port's snapshot restores into a JAX engine, which finishes the
    streams as the uninterrupted port engine does."""
    jm, tm = models
    want = _uninterrupted(lambda: LLMEngine(tm, device="cpu", **ENGINE))
    engine = LLMEngine(tm, device="cpu", **ENGINE)
    _add_mix(engine)
    for _ in range(4):
        engine.step()
    payload = json.loads(json.dumps(engine.state_payload()))
    j_engine = JLLMEngine(jm, **ENGINE)
    restored = j_engine.restore_state(payload)
    j_engine.run()
    assert {r.rid: r.generated for r in restored} == \
        {rid: want[rid] for rid in (r.rid for r in restored)}


@pytest.mark.parametrize("pipelined", [False, True])
def test_checkpointer_files_resume_byte_identically(models, tmp_path,
                                                    pipelined):
    _, tm = models
    want = _uninterrupted(lambda: LLMEngine(tm, device="cpu", **ENGINE))
    ck = ServeCheckpointer(str(tmp_path), save_every_n_steps=1,
                           max_checkpoints=2)
    engine = LLMEngine(tm, device="cpu", pipeline_decode=pipelined,
                       **ENGINE)
    _add_mix(engine)
    for n in range(1, 7):
        engine.step()
        ck.tick(n, engine.state_payload())
    assert ck._retained() == [5, 6]                   # rolling retention
    streamed = {}
    fresh = LLMEngine(tm, device="cpu", pipeline_decode=pipelined, **ENGINE)
    restored = fresh.restore_state(
        ServeCheckpointer(str(tmp_path)).restore(),
        on_token=lambda r, tok, text: streamed.setdefault(r.rid,
                                                          []).append(tok))
    assert [r.arrival_seq for r in restored] == sorted(
        r.arrival_seq for r in restored)
    fresh.run()
    for r in restored:
        assert r.generated == want[r.rid]
        assert streamed.get(r.rid, []) == want[r.rid][
            len(want[r.rid]) - len(streamed.get(r.rid, [])):]
    assert fresh.stats()["resumed"] == len(restored) > 0


def test_restore_scan_skips_corrupt_and_refuses_all_corrupt(tmp_path):
    ck = ServeCheckpointer(str(tmp_path), max_checkpoints=3)
    for step in (1, 2, 3):
        ck.save(step, {"requests": [], "next_rid": step})
    assert ck.restore()["next_rid"] == 3
    newest = os.path.join(ck.checkpoint_path(3), ck.CKPT_FILE)
    with open(newest, "r+b") as f:                    # flip one byte
        f.seek(3)
        byte = f.read(1)
        f.seek(3)
        f.write(bytes([byte[0] ^ 1]))
    with pytest.raises(CheckpointCorruptError):
        load_json(newest)
    assert ck.restore()["next_rid"] == 2              # the older one
    for step in (1, 2):
        path = os.path.join(ck.checkpoint_path(step), ck.CKPT_FILE)
        with open(path, "r+b") as f:
            f.truncate(10)
    with pytest.raises(CheckpointCorruptError, match="every retained"):
        ck.restore()
    assert ServeCheckpointer(str(tmp_path / "empty")).restore() is None
    assert ck.tick(4, {}) is not None and ck.tick(5, {}) is not None
    assert ServeCheckpointer(str(tmp_path), save_every_n_steps=2) \
        .tick(5, {}) is None


def test_save_json_is_atomic_and_round_trips(tmp_path):
    path = str(tmp_path / "d" / "state.json")
    payload = {"a": [1, 2, 3], "b": None, "c": {"x": 0.5}}
    save_json(payload, path)
    assert load_json(path) == payload
    assert os.listdir(tmp_path / "d") == ["state.json"]
    with open(path, "ab") as f:
        f.write(b"x")
    with pytest.raises(CheckpointCorruptError):
        load_json(path)


def test_torn_swap_is_refused(models):
    jm, tm = models
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_jax_state(model, {n: np.asarray(p._value)
                           for n, p in jm.named_parameters()})
    engine = LLMEngine(model, device="cpu", hot_swap=True, **ENGINE)
    _add_mix(engine)
    engine.step()
    payload = engine.state_payload()
    assert payload["weight_epoch"] == 0 and payload["weights_crc"]
    values = [v * 1.01 for v in jax_state_values(
        model, {n: np.asarray(p._value) for n, p in jm.named_parameters()})]
    other = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_jax_state(other, {n: np.asarray(p._value)
                           for n, p in jm.named_parameters()})
    swapped = LLMEngine(other, device="cpu", hot_swap=True, **ENGINE)
    assert swapped.swap_weights(values) == 1
    with pytest.raises(ServeRefusal) as ei:
        swapped.restore_state(payload)
    assert ei.value.reason == "torn_swap"
    assert swapped.requests == {}
    # the same weights restore, and the epoch carries over
    same = LLMEngine(model, device="cpu", hot_swap=True, **ENGINE)
    payload["weight_epoch"] = 3
    assert len(same.restore_state(payload)) == len(MIX)
    assert same.weight_epoch == 3


def test_unregistered_adapter_and_live_duplicate_are_refused(models):
    _, tm = models
    kw = dict(max_adapters=2, adapter_rank=2, **ENGINE)
    engine = LLMEngine(tm, device="cpu", **kw)
    engine.register_adapter("t1", seed=1)
    engine.add_request(_prompt(6, seed=1), max_new_tokens=4,
                       request_id="x", adapter="t1")
    payload = engine.state_payload()
    assert payload["adapters"] == ["t1"]
    bare = LLMEngine(tm, device="cpu", **kw)
    with pytest.raises(ServeRefusal) as ei:
        bare.restore_state(payload)
    assert ei.value.reason == "adapter_mismatch"
    with pytest.raises(ValueError, match="already live"):
        engine.restore_state(payload)
    assert LLMEngine(tm, device="cpu", **ENGINE).restore_state(None) == []
