"""Datasets and worker hooks for the data loader tests
(`tests/test_torch_io.py`). They live in a module of their own that
imports only numpy, because a worker process unpickles them by module:
importing the test module there would import both frameworks in every
worker. Map-style datasets need no base class in either package."""
from __future__ import annotations

import os
import time

import numpy as np


class Ranged:
    """Sample i: a float vector of i plus a numpy draw (the worker's
    seeded stream), a label, and a dict field."""

    def __init__(self, n=23, draw=True):
        self.n = n
        self.draw = draw

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        noise = np.random.rand(3).astype(np.float32) if self.draw \
            else np.zeros(3, np.float32)
        return (np.full((3,), i, np.float32) + noise, np.int64(i % 4),
                {"id": i, "w": float(i) / 2})


class Failing(Ranged):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom")
        return super().__getitem__(i)


class Dying(Ranged):
    """Its worker exits without a word at sample 5."""

    def __getitem__(self, i):
        if i == 5:
            os._exit(3)
        return super().__getitem__(i)


class Slow(Ranged):
    def __getitem__(self, i):
        time.sleep(30)
        return super().__getitem__(i)


class WorkerIds(Ranged):
    """Sample i: (i, the id, worker count and seed of the worker that
    loaded it)."""

    def __init__(self, info_fn, n=12):
        super().__init__(n, draw=False)
        self.info_fn = info_fn

    def __getitem__(self, i):
        info = self.info_fn()
        return np.array([i, info.id, info.num_workers, info.seed], np.int64)


class TouchMarker:
    """A worker_init_fn writing a marker file per worker."""

    def __init__(self, directory):
        self.directory = directory

    def __call__(self, worker_id):
        with open(os.path.join(self.directory, f"w{worker_id}"), "w") as f:
            f.write(str(worker_id))
