#!/usr/bin/env python3
"""Device memory that the port's objects hold, and whether dropping them
gives it back.

    python3 tools/torch_memory_release.py [--root DIR]

Builds, at GPT-2 124M's full width on the card, each kind of object that
a phase of `chip_smoke.py` builds (the serving engines: bf16 pools, int8
pools, pipelined, with the prefix cache and two adapters; a model's
`generate` programs; a bf16 `TrainStep` with its AdamW; the same under
`amp.auto_cast` O1), uses it, drops the last reference to it and reads
`torch.cuda.memory_allocated()`: right after the drop, with Python's
cyclic collector switched off, so that what reference counting alone
frees shows apart from what waits for `gc.collect()`, and again after
`gc.collect()` and `torch.cuda.empty_cache()`. One line an object:
held (allocated with it built less before it), freed on the drop, freed
after the collection, and whether a weak reference to it still lives at
each point; at the end, how much of what is left is PyTorch's cuBLAS
workspaces (one a handle and stream that ran a product). A model's
`generate` cache (`GEN_CACHE_SIZE` programs) is measured by clearing it.
`--root DIR` imports `paddle_tpu_torch` from DIR (an unpacked earlier
tree, say) instead of this checkout. Prints a JSON line last. Needs one
card; ~1 min of command time.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import weakref
from pathlib import Path

import numpy as np
import torch

GIB = 2.0 ** 30
# the serving objects' engine settings, as chip_smoke.py's serve phases
ENGINE = dict(max_batch_size=8, block_size=16, max_context=1024)
# generate's signatures: batch, prompt length, new tokens, sampled
GEN_SIGS = ((8, 128, 64, False), (8, 128, 64, True), (4, 64, 32, False),
            (2, 32, 16, True))


class _Box:
    """A weakly referable holder of one value."""

    def __init__(self, value):
        self.value = value


def _alloc():
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _prompts(rng, n, lo=16, hi=600):
    return [rng.integers(0, 50257, int(k)).tolist()
            for k in rng.integers(lo, hi, n)]


def _release(tag, held, key, base, out):
    """Drop held[key] (its only reference) and print what came back;
    `base` is what was allocated before it was made."""
    built = _alloc()
    ref = weakref.ref(held[key])
    del held[key]
    after_del = _alloc()
    alive_del = ref() is not None
    gc.collect()
    torch.cuda.empty_cache()
    after_gc = _alloc()
    alive_gc = ref() is not None
    row = {"object": tag, "held_gib": (built - base) / GIB,
           "freed_on_drop_gib": (built - after_del) / GIB,
           "freed_by_gc_gib": (after_del - after_gc) / GIB,
           "left_gib": (after_gc - base) / GIB,
           "alive_after_drop": alive_del, "alive_after_gc": alive_gc}
    print(f"memory {tag}: held {row['held_gib']:.3f} GiB; freed on the "
          f"drop {row['freed_on_drop_gib']:.3f} (object "
          f"{'alive' if alive_del else 'gone'}), freed by gc.collect "
          f"{row['freed_by_gc_gib']:.3f} (object "
          f"{'alive' if alive_gc else 'gone'}); left {row['left_gib']:.3f} "
          "GiB", flush=True)
    out.append(row)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.incubate.models import (GPTForCausalLM,
                                                  GPTPretrainingCriterion,
                                                  gpt2_124m)
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.serving import LLMEngine
    import paddle_tpu_torch
    print(f"root {Path(paddle_tpu_torch.__file__).parents[1]}", flush=True)
    _build.build_all()
    gc.collect()
    gc.disable()
    rng = np.random.default_rng(0)
    out = []
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model_base = _alloc()
    held = {"model": GPTForCausalLM(cfg, device="cuda", seed=0)
            .to(torch.bfloat16)}
    for tag, kw in (("LLMEngine bf16 pools", {}),
                    ("LLMEngine int8 pools", dict(kv_dtype="int8")),
                    ("LLMEngine pipelined", dict(pipeline_decode=True)),
                    ("LLMEngine prefix cache + 2 adapters",
                     dict(enable_prefix_cache=True, max_adapters=2,
                          adapter_rank=16, hot_swap=True))):
        base = _alloc()
        held["engine"] = LLMEngine(held["model"], **kw, **ENGINE)
        if kw.get("max_adapters"):
            held["engine"].register_adapter("a", seed=1, scale=4.0)
        held["engine"].generate(_prompts(rng, 6), max_new_tokens=8)
        _release(tag, held, "engine", base, out)
    base = _alloc()
    for b, p, n, sampled in GEN_SIGS:
        ids = torch.as_tensor(rng.integers(0, 50257, (b, p)))
        held["model"].generate(ids, n, do_sample=sampled, top_k=40,
                               top_p=0.95, temperature=0.8, seed=1)
    cache = held["model"]._gen_cache
    held["cache"] = _Box(dict(cache))
    cache.clear()
    del cache
    _release(f"generate cache ({len(GEN_SIGS)} signatures)", held, "cache",
             base, out)
    held["model"].generate(torch.as_tensor(rng.integers(0, 50257, (8, 128))),
                           64)
    _release("model (bf16) with one generate program", held, "model",
             model_base, out)
    ids, labels = (torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                (8, 1024))).cuda()
                   for _ in range(2))
    for tag, level in (("bf16", None), ("auto_cast O1", "O1")):
        model_base = _alloc()
        model = GPTForCausalLM(cfg, device="cuda", seed=0)
        if level is None:
            model = model.to(torch.bfloat16)
        model.train()
        held["model"] = model
        opt_base = _alloc()
        held["opt"] = AdamW(learning_rate=1e-4, weight_decay=0.01,
                            parameters=model.parameters(),
                            multi_precision=level is None)
        step_base = _alloc()
        held["step"] = TrainStep(model, GPTPretrainingCriterion(),
                                 held["opt"])
        del model
        for _ in range(2):
            if level is None:
                held["step"](ids, labels)
            else:
                with amp.auto_cast(level=level, dtype="bfloat16"):
                    held["step"](ids, labels)
        _release(f"TrainStep ({tag}, batch 8 x 1024; with the optimizer's "
                 "accumulators made at its first step)", held, "step",
                 step_base, out)
        _release(f"AdamW ({tag})", held, "opt", opt_base, out)
        _release(f"model ({tag}, trained)", held, "model", model_base, out)
    left = _alloc()
    torch._C._cuda_clearCublasWorkspaces()
    freed = (left - _alloc()) / GIB
    print(f"memory left at the end {left / GIB:.3f} GiB; cuBLAS workspaces "
          f"(one a handle and stream that ran a product, kept by PyTorch) "
          f"{freed:.3f} GiB of it", flush=True)
    gc.enable()
    print(json.dumps({"root": args.root, "objects": out}))


if __name__ == "__main__":
    main()
