#!/usr/bin/env python3
"""Profile the serving decode step's graph replay of one checkout of the
port on one card.

    python3 tools/torch_decode_replay.py [--root DIR] [--kv-dtype int8]
                                         [--steps 4] [--sampled N]
                                         [--adapters N] [--prefix]

Imports `paddle_tpu_torch` from DIR (default: this checkout), builds GPT-2
124M (full width, random weights from seed 0, bf16) behind
`LLMEngine(max_batch_size=8, block_size=16, max_context=1024)`, fills the
8 slots with 200-token prompts, lets the engine build its decode graph and
take 4 steps, then runs `--steps` decode steps of greedy slots (a tree
with a greedy sampler head replays that head; with `--sampled N` the
first N requests sample, temperature 0.8, top-k 40, top-p 0.95, so each
step replays the full sampler head; with `--adapters N` the engine has N
adapters of rank 16, registered from seeds 1..N with scale 4, and
request i decodes under adapter i mod N, so every slot's delta runs;
with `--prefix` the prefix cache is on and the 8 prompts share their
first 128 tokens, so all but each adapter's first are prefix hits, which
chew their tails before the profiled steps) under torch.profiler and
prints one JSON line: the card's name and power limit, the device kernels
and copies a step, device ms a step, ms and launches a step by kernel
(names cut to 90 characters; kernels whose names agree that far add
up), and, after the engine has run every request to its end, a SHA-256
of the 8 token streams. The same seeds give both checkouts the same
model, prompts and tokens. Run it on two checkouts in turns (parent,
change, change, parent) to compare their replays within one call. Needs a
CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--kv-dtype", default=None)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--sampled", type=int, default=0)
    ap.add_argument("--adapters", type=int, default=0)
    ap.add_argument("--prefix", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    from paddle_tpu_torch.incubate.models import GPTForCausalLM, gpt2_124m
    from paddle_tpu_torch.serving import LLMEngine

    if not torch.cuda.is_available():
        raise SystemExit("torch_decode_replay.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
    # tenancy options only where asked, so a checkout without them runs
    tenancy = {}
    if args.adapters:
        tenancy.update(max_adapters=args.adapters, adapter_rank=16)
    if args.prefix:
        tenancy["enable_prefix_cache"] = True
    engine = LLMEngine(model, max_batch_size=8, block_size=16,
                       max_context=1024, kv_dtype=args.kv_dtype, **tenancy)
    names = [f"t{i}" for i in range(1, args.adapters + 1)]
    for i, name in enumerate(names):
        engine.register_adapter(name, seed=i + 1, scale=4.0)
    rng = np.random.default_rng(0)
    reqs = []
    shared = np.random.default_rng(1).integers(0, 50257, 128).tolist()
    for i in range(8):
        sampling = dict(temperature=0.8, top_k=40, top_p=0.95, seed=i) \
            if i < args.sampled else {}
        if names:
            sampling["adapter"] = names[i % len(names)]
        prompt = rng.integers(0, 50257, 200).tolist()
        if args.prefix:
            prompt[:128] = shared
        reqs.append(engine.add_request(
            prompt, max_new_tokens=150 if args.prefix else 32, **sampling))
    # prefills, the graph's build, the prefix hits' 72 chew steps, then 4
    # plain replays
    for _ in range(77 if args.prefix else 5):
        engine.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    per = args.steps
    by_kernel, kernels, copies = {}, 0.0, 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n = evt.count / per
        if evt.key.startswith(("Memcpy", "Memset")):
            copies += n
        else:
            kernels += n
        # kernels whose names agree in their first 90 characters (one
        # template's instances) add up under that name
        ms, count = by_kernel.get(evt.key[:90], (0.0, 0.0))
        by_kernel[evt.key[:90]] = (
            ms + evt.self_device_time_total / 1e3 / per, count + n)
    device_ms = sum(ms for ms, _ in by_kernel.values())
    assert device_ms > 0, "the profiler saw no device time"
    engine.run()
    streams = json.dumps([list(r.generated) for r in reqs])
    print(json.dumps({
        "root": args.root, "card": card, "kv_dtype": args.kv_dtype or "bf16",
        "sampled": args.sampled, "adapters": args.adapters,
        "prefix": args.prefix, "steps": per, "kernels_per_step": kernels,
        "copies_per_step": copies, "device_ms_per_step": device_ms,
        "wall_ms_per_step": wall_ms,
        "streams_sha256": hashlib.sha256(streams.encode()).hexdigest(),
        "by_kernel": {name: [round(ms, 5), n] for name, (ms, n) in
                      sorted(by_kernel.items(), key=lambda kv: -kv[1][0])}}))


if __name__ == "__main__":
    main()
