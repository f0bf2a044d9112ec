"""The host's capacity for config 1's input pipeline, measured without the
DataLoader:

    python3 tools/torch_loader_cpu.py [--workers N] [--images M]

Prints the machine's CPUs (`os.cpu_count()`, the CPUs this process may
run on, the cgroup's CPU quota), then the time to load and transform one
synthetic 256 x 320 uint8 `.npy` image with `chip_smoke.py`'s vision_data
transforms (RandomResizedCrop(224), RandomHorizontalFlip, Transpose,
Normalize): in this process on one torch thread, then in N processes at
once (forkserver, one torch thread each): the most images/s N workers can
make. Then what a batch of 128 (float32, 77 MB) costs on its way: the
rate at which one child's batches come through a `multiprocessing` queue
(the loader's workers all answer through one), and, where there is a CUDA
device, pinning one and copying it to the card. The images are written
under the checkout's build/ and removed.
"""
import argparse
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from paddle_tpu_torch.vision import transforms as T  # noqa: E402

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


def _transform():
    return T.Compose([T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
                      T.Transpose(), T.Normalize(MEAN, STD)])


def _work(paths, seed):
    """Load and transform every image of `paths`; seconds taken."""
    torch.set_num_threads(1)
    np.random.seed(seed)
    transform = _transform()
    t0 = time.perf_counter()
    for p in paths:
        transform(np.load(p))
    return time.perf_counter() - t0


def _send(q, shape, n):
    batch = np.ones(shape, np.float32)
    for _ in range(n):
        q.put(batch)


def _cpu_quota():
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota, period = f.read().split()
        return "none" if quota == "max" else f"{int(quota) / int(period):g}"
    except (OSError, ValueError):
        return "unknown"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int,
                    default=min(8, os.cpu_count() - 1))
    ap.add_argument("--images", type=int, default=64)
    args = ap.parse_args()
    print(f"os.cpu_count() {os.cpu_count()}, usable CPUs "
          f"{len(os.sched_getaffinity(0))}, cgroup CPU quota {_cpu_quota()}")
    (ROOT / "build").mkdir(exist_ok=True)
    directory = tempfile.mkdtemp(prefix="loader_cpu_", dir=ROOT / "build")
    try:
        rng = np.random.default_rng(0)
        paths = []
        for i in range(args.images):
            paths.append(os.path.join(directory, f"{i}.npy"))
            np.save(paths[-1], rng.integers(0, 256, (256, 320, 3),
                                            dtype=np.uint8))
        threads = torch.get_num_threads()
        one = _work(paths, 0)
        torch.set_num_threads(threads)
        print(f"one process, one torch thread: {one / len(paths) * 1e3:.2f} "
              f"ms an image ({len(paths) / one:.1f} images/s)")
        ctx = multiprocessing.get_context("forkserver")
        with ctx.Pool(args.workers) as pool:
            pool.starmap(_work, [(paths[:2], w) for w in
                                 range(args.workers)])      # started
            t0 = time.perf_counter()
            secs = pool.starmap(_work, [(paths, w) for w in
                                        range(args.workers)])
            wall = time.perf_counter() - t0
        n = len(paths) * args.workers
        print(f"{args.workers} processes at once: {n / wall:.1f} images/s "
              f"({wall / len(paths) * 1e3:.2f} ms an image a process; each "
              f"process's own time {min(secs):.2f}–{max(secs):.2f} s for "
              f"{len(paths)})")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    shape = (128, 3, 224, 224)
    q = ctx.Queue()
    p = ctx.Process(target=_send, args=(q, shape, 6))
    p.start()
    batch = q.get()                      # the child's start, then batch 1
    t0 = time.perf_counter()
    for _ in range(5):
        batch = q.get()
    each = (time.perf_counter() - t0) / 5
    p.join()
    print(f"[128, 3, 224, 224] float32 batches through a queue from one "
          f"child: one every {each * 1e3:.1f} ms ({128 / each:.1f} images/s;"
          f" the child's pickling, the pipe and the parent's unpickling)")
    if torch.cuda.is_available():
        t = torch.from_numpy(batch)
        pins, copies = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            pinned = t.pin_memory()
            t1 = time.perf_counter()
            pinned.to("cuda", non_blocking=True)
            torch.cuda.synchronize()
            pins.append(t1 - t0)
            copies.append(time.perf_counter() - t1)
        print(f"pin_memory {np.median(pins) * 1e3:.1f} ms, copy to the card "
              f"{np.median(copies) * 1e3:.1f} ms (p50 of 5)")


if __name__ == "__main__":
    main()
