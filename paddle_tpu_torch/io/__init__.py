"""Data loading, PyTorch port: the samplers.

Counterpart of `paddle_tpu/io/` so far as data-parallel input needs it:
`Sampler` and its kin and `DistributedBatchSampler` (`io/sampler.py`).
`Dataset`, `DataLoader` and its workers are ROADMAP item 8(a).
"""
from .sampler import (  # noqa: F401
    Sampler, SequenceSampler, RandomSampler, BatchSampler,
    DistributedBatchSampler, WeightedRandomSampler,
)

__all__ = ["Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
           "DistributedBatchSampler", "WeightedRandomSampler"]
