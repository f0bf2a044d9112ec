"""Samplers, PyTorch port.

Counterpart of `paddle_tpu/io/sampler.py`, whose index arithmetic this
module copies (it is numpy in both packages), so that every sampler yields
the reference's indices: `RandomSampler` and `WeightedRandomSampler` draw
from numpy's global generator as the reference's do (seed it with
``np.random.seed``); `DistributedBatchSampler` pads the index list to a
multiple of the replicas by repeating its head, deals rank ``r`` every
``nranks``-th index from ``r``, and shuffles with
``np.random.default_rng(epoch)`` (`set_epoch`), so every rank agrees on
the permutation without communicating.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
           "WeightedRandomSampler", "DistributedBatchSampler"]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None \
            else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


def _batches(indices, batch_size, drop_last):
    batch = []
    for idx in indices:
        batch.append(idx)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        return _batches(self.sampler, self.batch_size, self.drop_last)

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Batches of this rank's share of the dataset's indices: each of
    `num_replicas` ranks sees ``ceil(len(dataset) / num_replicas)``
    samples (the list padded to equal length). Without `num_replicas` or
    `rank` they come from the data-parallel world
    (`paddle_tpu_torch.distributed`)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            from ..distributed import get_rank, get_world_size
            num_replicas = num_replicas or get_world_size()
            rank = rank if rank is not None else get_rank()
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.default_rng(self.epoch).permutation(n) \
                .tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - len(indices)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        return _batches(indices, self.batch_size, self.drop_last)

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
