#!/usr/bin/env python3
"""Profile the serving prefill of one checkout of the port on one card.

    python3 tools/torch_prefill_replay.py [--root DIR] [--kv-dtype int8]
        [--buckets 16,1024] [--scatter kernel|twin] [--eager]
        [--prefills 4]

Imports `paddle_tpu_torch` from DIR (default: this checkout), builds GPT-2
124M (full width, random weights from seed 0, bf16) behind
`LLMEngine(max_batch_size=8, block_size=16, max_context=1024)` and, for
each bucket, prefills a greedy prompt that fills the bucket through
`engine._prefill` (the bucket's program: one graph replay and a head's;
with `--eager`, `_prefill_eager`): 3 prefills to build and warm, 10 timed
on the host clock (each ends in the wait for its outputs), then
`--prefills` under torch.profiler. Prints one JSON line a bucket: the
card's name and power limit, kernels and copies a prefill, device ms a
prefill, the host p50, device ms and launches a prefill by kernel group
(flash, cuBLAS, scatter, sampler, other) and by kernel (the 12 largest,
names cut to 90 characters). `--scatter twin` routes the program's K/V
scatter through the kernel's plain twin on the card (the route before the
kernel), to see what the kernel replaced. The same seeds give every run
the same model and prompts. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

GROUPS = (("flash", ("flash_fwd",)),
          ("cuBLAS", ("gemm", "Gemm", "nvjet", "cutlass", "xmma")),
          ("scatter", ("prefill_scatter", "index_put", "scatter_",
                       "indexing_backward", "index_elementwise")),
          ("sampler", ("keyed_draw", "sampler_filter")))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--kv-dtype", default=None)
    ap.add_argument("--buckets", default="16,1024")
    ap.add_argument("--scatter", choices=("kernel", "twin"), default="kernel")
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--prefills", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    from paddle_tpu_torch.incubate.models import GPTForCausalLM, gpt2_124m
    from paddle_tpu_torch.kernels.prefill_scatter import \
        prefill_scatter_reference
    from paddle_tpu_torch.serving import LLMEngine, Request
    from paddle_tpu_torch.serving import engine as engine_module

    if not torch.cuda.is_available():
        raise SystemExit("torch_prefill_replay.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    if args.scatter == "twin":
        def twin(k_pools, v_pools, *rest, **kw):
            prefill_scatter_reference(k_pools, v_pools, *rest, **kw)
        engine_module.scatter_prefill = twin
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
    engine = LLMEngine(model, max_batch_size=8, block_size=16,
                       max_context=1024, kv_dtype=args.kv_dtype)
    prefill = engine._prefill_eager if args.eager else engine._prefill
    rng = np.random.default_rng(0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for bucket in (int(b) for b in args.buckets.split(",")):
        req = Request("p", rng.integers(0, 50257, bucket).tolist(), 1)
        req.slot = 0
        row = np.zeros(engine.max_blocks_per_seq, np.int32)
        used = -(-bucket // engine.block_size)
        row[:used] = np.arange(1, used + 1)

        def once():
            return prefill(req.prompt, bucket, row, req)

        for _ in range(3):
            once()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            once()
            walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.prefills):
                once()
            torch.cuda.synchronize()
        per = args.prefills
        by_kernel, groups, kernels, copies = {}, {}, 0.0, 0.0
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms, n = evt.self_device_time_total / 1e3 / per, evt.count / per
            if evt.key.startswith(("Memcpy", "Memset")):
                copies += n
            else:
                kernels += n
            group = next((g for g, pats in GROUPS
                          if any(p in evt.key for p in pats)), "other")
            g_ms, g_n = groups.get(group, (0.0, 0.0))
            groups[group] = (g_ms + ms, g_n + n)
            k_ms, k_n = by_kernel.get(evt.key[:90], (0.0, 0.0))
            by_kernel[evt.key[:90]] = (k_ms + ms, k_n + n)
        device_ms = sum(ms for ms, _ in groups.values())
        assert device_ms > 0, "the profiler saw no device time"
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
        print(json.dumps({
            "root": args.root, "card": card,
            "kv_dtype": args.kv_dtype or "bf16", "scatter": args.scatter,
            "mode": "eager" if args.eager else "program", "bucket": bucket,
            "prefills": per, "kernels_per_prefill": kernels,
            "copies_per_prefill": copies, "device_ms": device_ms,
            "wall_ms_p50": float(np.median(walls)),
            "prefill_compiles": engine.stats()["prefill_compiles"],
            "groups": {g: [round(ms, 5), n] for g, (ms, n) in
                       sorted(groups.items(), key=lambda kv: -kv[1][0])},
            "by_kernel": {name: [round(ms, 5), n] for name, (ms, n) in top}}),
            flush=True)


if __name__ == "__main__":
    main()
