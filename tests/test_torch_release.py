"""The port's long-lived objects give back what they hold when their last
user reference goes.

An engine's pools and graphs, a model's `generate` programs and a
`TrainStep`'s graph are device memory on the card. An object caught in a
reference cycle keeps all of it until Python's cyclic collector happens
to run, which late in a long process may be many objects later: an
engine's CPU decode and prefill programs held its bound methods, and a
`generate` program held its model, whose cache holds the program, and
the adapters' forward hooks, which the model holds, held the model. Each
object here is built at a tiny size on the CPU, used, and dropped with
the cyclic collector switched off: a weak reference to it must die with
the drop, and so after `gc.collect()`.
"""
from __future__ import annotations

import gc
import weakref

import pytest
import torch

from paddle_tpu_torch.incubate.models import (GPTConfig, GPTForCausalLM,
                                              GPTPretrainingCriterion)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import LLMEngine

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
ENGINE = dict(max_batch_size=2, block_size=8, max_context=64, device="cpu")


def _model(seed=0):
    return GPTForCausalLM(GPTConfig(**CFG), device="cpu", seed=seed)


def _released(make):
    """(alive after the drop, alive after gc.collect()) of what `make`
    returns, the cyclic collector off until the collection."""
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        ref = weakref.ref(make())
        on_drop = ref() is not None
        gc.collect()
        return on_drop, ref() is not None
    finally:
        if was:
            gc.enable()


def _engine(model, **kw):
    engine = LLMEngine(model, **ENGINE, **kw)
    if kw.get("max_adapters"):
        engine.register_adapter("a", seed=1, scale=4.0)
    engine.generate([[1, 2, 3, 4, 5, 6, 7, 8, 9], [5, 6]], max_new_tokens=3)
    return engine


@pytest.mark.parametrize("kw", [
    {}, dict(kv_dtype="int8"), dict(pipeline_decode=True),
    dict(enable_prefix_cache=True, max_adapters=2, adapter_rank=4,
         hot_swap=True)],
    ids=["bf16", "int8", "pipelined", "tenancy"])
def test_engine_goes_with_its_last_reference(kw):
    model = _model()
    assert _released(lambda: _engine(model, **kw)) == (False, False)


def test_model_with_generate_programs_goes_with_its_last_reference():
    def make():
        model = _model()
        ids = torch.tensor([[1, 2, 3], [4, 5, 6]])
        model.generate(ids, 4)
        model.generate(ids, 4, do_sample=True, top_k=5, seed=1)
        assert len(model._gen_cache) == 2
        return model

    assert _released(make) == (False, False)


def test_model_that_served_adapters_goes_with_its_last_reference():
    """The adapters' forward hooks stay on the model after its engine
    goes; they must not keep the model."""
    def make():
        model = _model()
        engine = _engine(model, enable_prefix_cache=True, max_adapters=2,
                         adapter_rank=4, hot_swap=True)
        del engine
        model.generate(torch.tensor([[1, 2, 3]]), 3)
        return model

    assert _released(make) == (False, False)


def test_generate_program_does_not_keep_its_model():
    model = _model()
    model.generate(torch.tensor([[1, 2, 3]]), 3)
    (program,) = model._gen_cache.values()
    assert program.model is model
    ref = weakref.ref(model)
    del model
    assert ref() is None and program.model is None


def test_train_step_and_optimizer_go_with_their_last_reference():
    ids = torch.randint(0, CFG["vocab_size"], (2, 16),
                        generator=torch.Generator().manual_seed(0))

    def make():
        model = _model()
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        step = TrainStep(model, GPTPretrainingCriterion(), opt)
        step(ids, ids)
        return step

    assert _released(make) == (False, False)
