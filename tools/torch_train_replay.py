#!/usr/bin/env python3
"""Profile the training step's graph replay of one checkout of the port on
one card, and hash the state it leaves.

    python3 tools/torch_train_replay.py [--root DIR] [--guard]
                                        [--steps 3] [--profile 4]

Imports `paddle_tpu_torch` from DIR (default: this checkout), builds GPT-2
124M (full width, random weights from seed 0, dropout 0, bf16) with
AdamW(multi_precision, weight decay 0.01) and `TrainStep`, the fused
cross-entropy on, and takes `--steps` steps on batch 8 x 1024 from seed
0; then prints one JSON line: the card's name and power limit, the
losses, a SHA-256 of the bits of every parameter, master and moment after
those steps, and, over `--profile` more steps under torch.profiler, the
device kernels and copies a step and the device ms a step. With
``--guard`` the steps run under ``FLAGS_check_numerics`` (the numeric
guard; a tree that lacks the flag refuses). The same seeds give two
checkouts the same model and batch, so equal hashes mean equal state bit
for bit. Run it on two checkouts in turns (parent, change, change, parent)
to compare them within one call. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--guard", action="store_true")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--profile", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    from paddle_tpu_torch.framework import set_flags
    from paddle_tpu_torch.incubate.models import (GPTForCausalLM,
                                                  GPTPretrainingCriterion,
                                                  gpt2_124m)
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    if not torch.cuda.is_available():
        raise SystemExit("torch_train_replay.py needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cfg = gpt2_124m(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    rng = np.random.default_rng(0)
    ids, labels = (torch.tensor(rng.integers(0, cfg.vocab_size, (8, 1024)),
                                device="cuda") for _ in range(2))
    model = GPTForCausalLM(cfg, device="cuda", seed=0).to(torch.bfloat16)
    model.train()
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    step = TrainStep(model, GPTPretrainingCriterion(), opt)
    flags = {"FLAGS_use_fused_cross_entropy": True}
    if args.guard:
        flags["FLAGS_check_numerics"] = True
    set_flags(flags)
    losses = [float(step(ids, labels)) for _ in range(args.steps)]
    digest = hashlib.sha256()
    state = [p.detach() for p in model.parameters()] + [
        slot[p] for _, slot in sorted(opt._accumulators.items())
        for p in model.parameters() if p in slot]
    for t in state:
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy()
                      .tobytes())
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.profile):
            float(step(ids, labels))
        torch.cuda.synchronize()
    kernels = copies = device_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += evt.self_device_time_total
        if evt.key.startswith(("Memcpy", "Memset")):
            copies += evt.count
        else:
            kernels += evt.count
    print(json.dumps({
        "card": card, "root": args.root, "guard": args.guard,
        "losses": losses, "state_sha256": digest.hexdigest(),
        "builds": step._builds,
        "kernels_per_step": kernels / args.profile,
        "copies_per_step": copies / args.profile,
        "device_ms_per_step": device_us / 1e3 / args.profile}))


if __name__ == "__main__":
    main()
