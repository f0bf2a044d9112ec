"""Datasets, PyTorch port.

Counterpart of `paddle_tpu/io/dataset.py`, whose code this module copies:
it is plain Python and numpy in both packages. `TensorDataset` indexes
whatever it is given (numpy arrays or torch tensors) along the first axis;
`random_split` draws its permutation from numpy's global generator, as the
reference's does.
"""
from __future__ import annotations

import bisect

import numpy as np

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lengths = {t.shape[0] for t in tensors}
        if len(lengths) > 1:
            raise ValueError("all tensors must have the same first dimension")
        self.tensors = tensors

    def __getitem__(self, index):
        return tuple(t[index] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            item = d[idx]
            sample.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(sample)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]) \
            .tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if sum(lengths) != total:
        raise ValueError("sum of lengths must equal dataset length")
    perm = np.random.permutation(total)
    out = []
    offset = 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out
