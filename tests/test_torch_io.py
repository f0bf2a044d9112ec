"""Port parity: `paddle_tpu_torch.io` (the datasets, `DataLoader` with its
worker processes and prefetch thread) and `framework.random`'s seed
against the JAX package's `paddle_tpu.io`, and the cases of the
reference's `tests/test_dataloader_mp.py`.

Batches are compared exactly: both packages run the same numpy code in
the same order (sampling, each worker's seeded draws, collation), so
every batch is equal, dtype included. The workers' base seed comes from
each package's seed and module-level epoch counter; each test that
compares seeded workers resets both counters, so that tests running in
any order on any xdist worker agree. Worker processes start from a
forkserver (a few seconds the first time in a process), so the tests
that start them are few; their datasets live in `torch_io_datasets`,
which imports only numpy.
"""
from __future__ import annotations

import itertools
import os
import threading
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
import paddle_tpu.io.dataloader as jdl

import paddle_tpu_torch.io as tio
import paddle_tpu_torch.io.dataloader as tdl
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.framework import seed as tseed

import torch_io_datasets as ds
from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _seeded(monkeypatch):
    """Both packages seeded with 0 (the reference's conftest seeds it) and
    both epoch counters restarted."""
    paddle.seed(0)
    tseed(0)
    monkeypatch.setattr(jdl, "_epoch_counter", itertools.count())
    monkeypatch.setattr(tdl, "_epoch_counter", itertools.count())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "_value"):
        return np.asarray(x._value)
    return x


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is type(w) or isinstance(g, torch.Tensor)
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            _assert_batches_equal(list(g.values()), list(w.values()))
        elif isinstance(w, (tuple, list)):
            _assert_batches_equal(list(g), list(w))
        elif isinstance(g, (torch.Tensor, np.ndarray)):
            assert not isinstance(g, torch.Tensor) or g.device.type == "cpu"
            a, b = _np(g), _np(w)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert g == w


def _both(dataset, **kw):
    """The batches of one epoch from each package's DataLoader, the numpy
    global generator reseeded before each."""
    np.random.seed(7)
    want = list(jio.DataLoader(dataset, **kw))
    np.random.seed(7)
    got = list(tio.DataLoader(dataset, places="cpu", **kw))
    return got, want


# ------------------------------------------------------------- datasets

def test_map_datasets_equal_reference():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.arange(6, dtype=np.int64)
    pairs = [
        (tio.TensorDataset([a, b]), jio.TensorDataset([a, b])),
        (tio.ComposeDataset([tio.TensorDataset([a]), ds.Ranged(6, False)]),
         jio.ComposeDataset([jio.TensorDataset([a]), ds.Ranged(6, False)])),
        (tio.ConcatDataset([tio.TensorDataset([a]), ds.Ranged(4, False)]),
         jio.dataset.ConcatDataset([jio.TensorDataset([a]),
                                    ds.Ranged(4, False)])),
        (tio.Subset(ds.Ranged(9, False), [8, 0, 3]),
         jio.Subset(ds.Ranged(9, False), [8, 0, 3])),
    ]
    for t, j in pairs:
        assert len(t) == len(j)
        for i in list(range(len(j))) + [-1]:
            _assert_batches_equal(list(t[i]), list(j[i]))
    t = tio.TensorDataset([torch.from_numpy(a), torch.from_numpy(b)])
    assert len(t) == 6 and int(t[3][1]) == 3
    with pytest.raises(ValueError):
        tio.TensorDataset([a, b[:3]])
    np.random.seed(3)
    want = [s.indices for s in jio.random_split(ds.Ranged(10), [3, 7])]
    np.random.seed(3)
    got = [s.indices for s in tio.random_split(ds.Ranged(10), [3, 7])]
    assert got == want


class _Stream(tio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.full((2,), i, np.float32), i


class _JStream(jio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.full((2,), i, np.float32), i


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_and_chain_datasets(drop_last):
    got = list(tio.DataLoader(tio.ChainDataset([_Stream(5), _Stream(6)]),
                              batch_size=4, drop_last=drop_last,
                              places="cpu"))
    want = list(jio.DataLoader(jio.ChainDataset([_JStream(5), _JStream(6)]),
                               batch_size=4, drop_last=drop_last))
    _assert_batches_equal(got, want)
    with pytest.raises(TypeError):
        len(tio.DataLoader(_Stream(3), places="cpu"))
    with pytest.raises(RuntimeError):
        _Stream(3)[0]


# ---------------------------------------------------------- in process

@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=5, shuffle=True, drop_last=True),
    dict(batch_size=3, shuffle=True, use_buffer_reader=False),
    dict(batch_size=4, prefetch_factor=1),
])
def test_loader_in_process_equals_reference(kw):
    got, want = _both(ds.Ranged(), **kw)
    _assert_batches_equal(got, want)


def test_batch_sampler_and_custom_collate_in_process():
    sampler = tio.BatchSampler(ds.Ranged(10), batch_size=3)
    jsampler = jio.BatchSampler(ds.Ranged(10), batch_size=3)
    got = list(tio.DataLoader(ds.Ranged(10, False), batch_sampler=sampler,
                              collate_fn=lambda s: [x[1] for x in s],
                              places="cpu"))
    want = list(jio.DataLoader(ds.Ranged(10, False), batch_sampler=jsampler,
                               collate_fn=lambda s: [x[1] for x in s]))
    assert got == want
    assert len(tio.DataLoader(ds.Ranged(10), batch_sampler=sampler,
                              places="cpu")) == 4


def test_default_collate_fn_types():
    out = tio.default_collate_fn([(np.zeros((2,), np.float16), 1, 2.5,
                                   torch.ones(3)),
                                  (np.ones((2,), np.float16), 2, 3.5,
                                   torch.zeros(3))])
    assert out[0].dtype == torch.float16 and out[0].shape == (2, 2)
    assert out[1].dtype == torch.int64 and out[1].tolist() == [1, 2]
    assert out[2].dtype == torch.float32
    assert out[3].shape == (2, 3)
    assert tio.default_collate_fn(["a", "b"]) == ["a", "b"]


def test_places_none_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: places=None means cuda there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.DataLoader(ds.Ranged())
    with pytest.raises(ValueError):
        tio.DataLoader(ds.Ranged(), places=["cpu", "cpu"])
    assert tio.DataLoader(ds.Ranged(), places=["cpu"]).places.type == "cpu"


def test_bounded_queue_contract():
    q = tdl._BoundedQueue(2)
    assert q.push(1) and q.push(2)
    pushed = []
    t = threading.Thread(target=lambda: pushed.append(q.push(3)))
    t.start()
    t.join(0.2)
    assert t.is_alive()             # blocked while full
    assert q.pop() == 1
    t.join(5)
    assert not t.is_alive() and pushed == [True]
    q.close()
    assert q.push(4) is False       # closed: push says so, never blocks
    assert q.pop() == 2 and q.pop() == 3
    with pytest.raises(StopIteration):
        q.pop()


def test_prefetch_iterator_raises_the_producers_error():
    def produce():
        yield 1
        raise KeyError("late")

    it = tdl._PrefetchIterator(produce, tdl._DeviceStager(
        torch.device("cpu")))
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)
    it.close()


def test_seed_sets_the_default_generator():
    tseed(1234)
    assert trandom.default_generator.seeded
    assert trandom.default_generator.initial_seed == 1234
    assert tdl._base_seed() == (1234 * 1000003) % (2 ** 31)
    assert tdl._base_seed() == (1234 * 1000003 + 10007) % (2 ** 31)


# --------------------------------------------------------- worker processes

def _dealt(dataset, batches, num_workers, base_seed):
    """The batches as dealt workers draw them, rebuilt in this process:
    batch b from worker b mod num_workers, whose numpy stream starts at
    base_seed + its id."""
    streams = []
    for w in range(num_workers):
        np.random.seed(base_seed + w)
        streams.append(np.random.get_state())
    out = []
    for b, indices in enumerate(batches):
        np.random.set_state(streams[b % num_workers])
        out.append(tdl._to_tensors(tdl._np_collate(
            [dataset[i] for i in indices])))
        streams[b % num_workers] = np.random.get_state()
    return out


def test_workers_equal_reference_seeded_and_in_order(monkeypatch):
    """Worker batches in order, over two epochs (the epoch counter moves
    both packages' base seeds alike): with one worker, the workers' seeded
    draws included, equal to the reference's; with two, equal to the
    reference's without draws (the reference's workers take batches from a
    shared queue, so which worker draws a batch varies) and, with draws,
    to the dealt batches rebuilt in this process."""
    for kw in (dict(batch_size=4), dict(batch_size=3, shuffle=True,
                                        drop_last=True, prefetch_factor=1)):
        np.random.seed(11)
        jl = jio.DataLoader(ds.Ranged(), num_workers=1, **kw)
        want = [list(jl), list(jl)]
        np.random.seed(11)
        tl = tio.DataLoader(ds.Ranged(), num_workers=1, places="cpu", **kw)
        got = [list(tl), list(tl)]
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
        # the two epochs drew differently
        assert not np.array_equal(_np(got[0][0][0]), _np(got[1][0][0]))
    got, want = _both(ds.Ranged(draw=False), batch_size=4, shuffle=True,
                      num_workers=2)
    _assert_batches_equal(got, want)
    np.random.seed(5)
    batches = list(tio.BatchSampler(ds.Ranged(), batch_size=3,
                                    shuffle=True))
    monkeypatch.setattr(tdl, "_epoch_counter", itertools.count(3))
    np.random.seed(5)
    got = list(tio.DataLoader(ds.Ranged(), batch_size=3, shuffle=True,
                              num_workers=2, places="cpu"))
    _assert_batches_equal(got, _dealt(ds.Ranged(), batches, 2, 3 * 10007))


def test_workers_info_init_fn_and_custom_collate(tmp_path):
    dl = tio.DataLoader(ds.WorkerIds(tdl.get_worker_info), batch_size=2,
                        num_workers=2, places="cpu",
                        worker_init_fn=ds.TouchMarker(str(tmp_path)))
    rows = torch.cat(list(dl)).numpy()
    np.testing.assert_array_equal(rows[:, 0], np.arange(12))
    # dealt: batch b (rows 2b, 2b + 1) from worker b mod 2, whose seed is
    # base 0 (seed 0, epoch 0) plus its id
    np.testing.assert_array_equal(rows[:, 1], np.arange(12) // 2 % 2)
    assert (rows[:, 2] == 2).all()
    np.testing.assert_array_equal(rows[:, 3], rows[:, 1])
    assert sorted(os.listdir(str(tmp_path))) == ["w0", "w1"]
    assert tdl.get_worker_info() is None
    out = list(tio.DataLoader(ds.Ranged(), batch_size=4, num_workers=2,
                              places="cpu",
                              collate_fn=lambda samples: len(samples)))
    assert out == [4, 4, 4, 4, 4, 3]


def test_workers_fail_loudly():
    """A worker's exception, a worker that dies and a timeout each raise
    in the parent; no fork warning is given."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pytest.raises(RuntimeError, match="boom"):
            list(tio.DataLoader(ds.Failing(), batch_size=4, num_workers=2,
                                places="cpu"))
    msgs = [str(w.message) for w in caught]
    assert not any("fork" in m and "thread" in m for m in msgs), msgs
    with pytest.raises(RuntimeError, match="died"):
        list(tio.DataLoader(ds.Dying(), batch_size=4, num_workers=2,
                            places="cpu"))
    with pytest.raises(RuntimeError, match="timed out"):
        list(tio.DataLoader(ds.Slow(), batch_size=4, num_workers=1,
                            places="cpu", timeout=1))
