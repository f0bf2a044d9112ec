"""Data loading, PyTorch port.

Counterpart of `paddle_tpu/io/`: the datasets (`io/dataset.py`), the
samplers with `DistributedBatchSampler` (`io/sampler.py`) and `DataLoader`
with its worker processes and prefetch thread (`io/dataloader.py`), whose
batches land on the card unless the caller names another device.
"""
from .dataset import (  # noqa: F401
    Dataset, IterableDataset, TensorDataset, ComposeDataset, ChainDataset,
    ConcatDataset, Subset, random_split,
)
from .sampler import (  # noqa: F401
    Sampler, SequenceSampler, RandomSampler, BatchSampler,
    DistributedBatchSampler, WeightedRandomSampler,
)
from .dataloader import (  # noqa: F401
    DataLoader, default_collate_fn, get_worker_info, WorkerInfo)

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
           "DistributedBatchSampler", "WeightedRandomSampler", "DataLoader",
           "default_collate_fn", "get_worker_info", "WorkerInfo"]
