"""The global seed, PyTorch port.

Counterpart of the part of `paddle_tpu/framework/random.py` that the data
loader reads (reference :48-61, :143-146): `seed` and a default generator
that records the seed it was given (`initial_seed`) and whether the
program seeded it at all (`seeded`). `DataLoader` derives its workers'
base seed from these, deterministically when `seeded` and from fresh
entropy otherwise (`io/dataloader.py`).

The reference's generator is a `jax.random` key stream; the port's random
ops draw from `torch.Generator`s, so `seed` also reseeds torch's default
generator, the stream an op without a generator of its own draws from.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "default_generator"]


class _GlobalGenerator:
    """The seed of the program's global random stream."""

    def __init__(self, seed_val: int = 0):
        self._lock = threading.Lock()
        self.initial_seed = seed_val
        # whether the program seeded explicitly (`seed`): the data loader's
        # workers are deterministic if and only if it did
        self.seeded = False

    def manual_seed(self, seed_val: int):
        with self._lock:
            self.initial_seed = int(seed_val)
            self.seeded = True
            torch.manual_seed(int(seed_val))
        return self


default_generator = _GlobalGenerator(0)


def seed(seed_val: int):
    """`paddle.seed`: reseed the global generator."""
    return default_generator.manual_seed(seed_val)
