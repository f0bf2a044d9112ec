"""DataLoader with worker processes and a prefetch thread, PyTorch port.

Counterpart of `paddle_tpu/io/dataloader.py`, keeping its design:

- **Workers.** With ``num_workers > 0`` batches are assembled in worker
  PROCESSES started from a FORKSERVER that preloads this module (the
  import is paid once; each worker is a cheap fork of the server's
  single-threaded state, never of the parent, whose CUDA context and
  threads a fork would copy). A worker runs numpy and torch on the CPU
  only, on one intra-op thread (the reference's workers are
  single-threaded numpy), and never initialises CUDA: importing this
  module builds no kernel and touches no device. Workers collate in numpy
  (`_np_collate`); a custom ``collate_fn`` runs in the parent on the raw
  samples.
- **Seeds.** A worker seeds numpy's global generator with the base seed
  plus its id. A seeded program (`framework.seed`) derives the base seed
  from the seed and an epoch counter, ``(seed · 1000003 + epoch · 10007)
  mod 2^31``, so worker k's augmentations repeat run to run; an unseeded
  one takes fresh entropy.
- **Order and window.** Batch b goes to worker b mod ``num_workers``
  (the reference's workers share one task queue), so a batch's draws
  depend on the seed and its index alone. Results come back in order,
  with at most ``num_workers × prefetch_factor`` batches in flight. A
  worker that dies and a ``timeout`` raise RuntimeError instead of
  hanging; an exception in a worker is raised in the parent. Shutdown
  sends each worker a sentinel first and terminates only stragglers.
- **Prefetch and device.** A thread produces batches into a bounded queue
  (`_BoundedQueue`, the contract of the reference's native queue:
  ``push`` returns False once the queue is closed). Batches land on
  ``places`` (None means ``cuda``, raising where there is none, as every
  entry point of the port does; the tests pass ``"cpu"``). On a CUDA
  device the thread copies each batch from pinned host memory on a side
  stream and records an event; ``__next__`` makes the consumer's stream
  wait on it and calls ``record_stream``, so the consumer's kernels (a
  `TrainStep`'s copy into its static buffers) read the batch only after
  its copy, and its memory is not reused while they may. A pinned block
  is not reused before its copy completes (PyTorch's caching host
  allocator records the copy's event on it).

The reference keeps its blocking queue and its parallel collation in its
native core (`paddle_tpu/core/__init__.py:203-280`); the port uses a
Python queue and `np.stack` until the port's native services land
(ROADMAP Queue 1 item 8(b)). ``use_shared_memory`` and
``persistent_workers`` are accepted and ignored, as in the reference.
"""
from __future__ import annotations

import collections
import itertools
import multiprocessing
import queue
import threading
from time import monotonic as _monotonic

import numpy as np
import torch

from ..device import resolve_device
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info", "WorkerInfo"]


def _np_collate(batch):
    """Numpy-only collation for worker processes."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        batch = [b.numpy() for b in batch]
        sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (list, tuple)):
        return tuple(_np_collate(list(items)) for items in zip(*batch))
    if isinstance(sample, dict):
        return {k: _np_collate([b[k] for b in batch]) for k in sample}
    return batch


def _to_tensors(data):
    if isinstance(data, np.ndarray):
        return torch.from_numpy(data)
    if isinstance(data, tuple):
        return tuple(_to_tensors(d) for d in data)
    if isinstance(data, dict):
        return {k: _to_tensors(v) for k, v in data.items()}
    return data


def _map_tensors(data, fn):
    """`data` with fn applied to every torch tensor in its tuples, lists
    and dicts."""
    if isinstance(data, torch.Tensor):
        return fn(data)
    if isinstance(data, (tuple, list)):
        return type(data)(_map_tensors(d, fn) for d in data)
    if isinstance(data, dict):
        return {k: _map_tensors(v, fn) for k, v in data.items()}
    return data


def _worker_loop(dataset, task_q, result_q, worker_id, worker_init_fn,
                 raw_samples, num_workers=0, base_seed=0):
    """Body of one worker process: pulls (batch_idx, indices), pushes
    (batch_idx, payload, error), numpy only."""
    global _worker_info
    torch.set_num_threads(1)
    seed = (base_seed + worker_id) % (2 ** 31)
    _worker_info = WorkerInfo(worker_id, num_workers, dataset, seed=seed)
    np.random.seed(seed)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        task = task_q.get()
        if task is None:
            return
        bidx, indices = task
        try:
            samples = [dataset[i] for i in indices]
            payload = samples if raw_samples else _np_collate(samples)
            result_q.put((bidx, payload, None))
        except Exception as e:          # ship the error to the parent
            result_q.put((bidx, None, f"{type(e).__name__}: {e}"))


_WORKER_CTX = None
# monotonic epoch counter feeding per-producer base seeds (deterministic,
# unlike SeedSequence entropy)
_epoch_counter = itertools.count()


def _worker_context():
    """The forkserver context whose server preloads this module."""
    global _WORKER_CTX
    if _WORKER_CTX is None:
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload(["paddle_tpu_torch.io.dataloader"])
        _WORKER_CTX = ctx
    return _WORKER_CTX


def _base_seed():
    """The workers' base seed: from the program's seed and the epoch
    counter when it seeded (`framework.seed`), else fresh entropy."""
    from ..framework.random import default_generator
    if default_generator.seeded:
        return (int(default_generator.initial_seed) * 1000003
                + next(_epoch_counter) * 10007) % (2 ** 31)
    return int(np.random.SeedSequence().entropy % (2 ** 31))


class _MultiprocessProducer:
    """Deal index batches to worker processes, batch b to worker b mod
    num_workers; yield the results IN ORDER, with at most num_workers *
    prefetch_factor batches in flight.

    The reference's workers take the next batch from one shared queue, so
    which worker (and which part of its seeded stream) draws a batch's
    augmentations varies run to run; dealt batches make each batch's
    draws a function of the seed and the batch's index alone."""

    def __init__(self, dataset, batches, num_workers, worker_init_fn,
                 timeout, raw_samples, prefetch_factor=2):
        ctx = _worker_context()
        self._task_qs = [ctx.SimpleQueue() for _ in range(num_workers)]
        self._result_q = ctx.Queue()
        self._timeout = timeout
        self._depth = max(1, num_workers * max(prefetch_factor, 1))
        self._workers = []
        base_seed = _base_seed()
        for w in range(num_workers):
            p = ctx.Process(target=_worker_loop,
                            args=(dataset, self._task_qs[w], self._result_q,
                                  w, worker_init_fn, raw_samples,
                                  num_workers, base_seed),
                            daemon=True)
            p.start()
            self._workers.append(p)
        self._batches = list(batches)

    def _submit(self, bidx):
        self._task_qs[bidx % len(self._task_qs)].put(
            (bidx, list(self._batches[bidx])))

    def _get_result(self):
        """Wait for one result, polling the workers' liveness (a killed
        worker surfaces as an error, not a hang) and the timeout."""
        deadline = (_monotonic() + self._timeout) if self._timeout else None
        while True:
            try:
                return self._result_q.get(timeout=1.0)
            except queue.Empty:
                if any(not p.is_alive() for p in self._workers):
                    raise RuntimeError(
                        "a DataLoader worker process died unexpectedly "
                        "(killed or crashed before reporting)") from None
                if deadline is not None and _monotonic() > deadline:
                    raise RuntimeError(
                        f"DataLoader worker timed out after "
                        f"{self._timeout}s") from None

    def __iter__(self):
        try:
            n = len(self._batches)
            submitted = 0
            while submitted < min(self._depth, n):
                self._submit(submitted)
                submitted += 1
            pending = {}
            for want in range(n):
                while want not in pending:
                    bidx, payload, err = self._get_result()
                    if err is not None:
                        raise RuntimeError(
                            f"DataLoader worker failed on batch {bidx}: "
                            f"{err}")
                    pending[bidx] = payload
                    if submitted < n:
                        self._submit(submitted)
                        submitted += 1
                yield pending.pop(want)
        finally:
            self.close()

    def close(self):
        # graceful first: a sentinel lets a worker still inside its start
        # run its worker_init_fn and exit; stragglers are terminated after
        # a bounded join
        for task_q in self._task_qs[:len(self._workers)]:
            try:
                task_q.put(None)
            except OSError:
                break
        deadline = _monotonic() + 5.0
        for p in self._workers:
            p.join(timeout=max(0.1, deadline - _monotonic()))
        for p in self._workers:
            if p.is_alive():
                p.terminate()
        for p in self._workers:
            p.join(timeout=1.0)
        self._workers = []


def default_collate_fn(batch):
    """Stack a list of samples into CPU tensors: arrays and tensors along
    a new first axis, ints as int64, floats as float32, tuples and dicts
    field by field."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, np.float32))
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return tuple(default_collate_fn(list(items)) for items in transposed)
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


class _BoundedQueue:
    """Bounded blocking queue with the reference's native contract
    (`paddle_tpu/core/__init__.py` BoundedQueue): `push` blocks while the
    queue is full and returns False once it is closed; `pop` raises
    StopIteration once it is closed and drained."""

    def __init__(self, capacity):
        self._items = collections.deque()
        self._capacity = capacity
        self._cond = threading.Condition()
        self._closed = False

    def push(self, obj):
        with self._cond:
            while len(self._items) >= self._capacity and not self._closed:
                self._cond.wait()
            if self._closed:
                return False
            self._items.append(obj)
            self._cond.notify_all()
            return True

    def pop(self):
        with self._cond:
            while not self._items and not self._closed:
                self._cond.wait()
            if not self._items:
                raise StopIteration
            item = self._items.popleft()
            self._cond.notify_all()
            return item

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class _DeviceStager:
    """Moves a host batch's tensors onto `device`. On a CUDA device the
    copy is made from pinned memory on a side stream (the producer
    thread's) and `land` orders the consumer's stream after it."""

    def __init__(self, device):
        self.device = device
        self._stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def send(self, batch):
        """(batch on the device, the copy's event or None)."""
        if self._stream is None:
            return _map_tensors(batch, lambda t: t.to(self.device)), None
        with torch.cuda.stream(self._stream):
            moved = _map_tensors(batch, lambda t: t.pin_memory().to(
                self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        return moved, event

    def land(self, moved, event):
        """The batch, safe to use on the consumer's current stream."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            _map_tensors(moved, lambda t: t.record_stream(stream))
        return moved


class _PrefetchIterator:
    """A producer thread fills a bounded queue with batches already sent
    to the device (the reference's buffered reader)."""

    def __init__(self, produce_batches, stager, prefetch=2):
        self._q = _BoundedQueue(max(prefetch, 1))
        self._stager = stager
        self._exc = None
        self._thread = threading.Thread(target=self._run,
                                        args=(produce_batches,), daemon=True)
        self._thread.start()

    def _run(self, produce_batches):
        batches = produce_batches()
        try:
            for b in batches:
                if not self._q.push(self._stager.send(b)):
                    return  # consumer closed the queue
        except BaseException as e:  # raised again in the consumer
            self._exc = e
        finally:
            batches.close()         # stops the workers now, not at gc
            self._q.close()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            moved, event = self._q.pop()
        except StopIteration:
            if self._exc is not None:
                raise self._exc from None
            raise
        return self._stager.land(moved, event)

    def close(self):
        """Wake a blocked producer and join it."""
        self._q.close()
        self._thread.join(timeout=5.0)

    def __del__(self):
        try:
            self.close()
        except RuntimeError:
            pass


class DataLoader:
    """Iterates over `dataset` in batches on `places` (None: ``cuda``,
    raising where there is none). Reference arguments; ``feed_list``,
    ``return_list``, ``use_shared_memory`` and ``persistent_workers`` are
    accepted and not read."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        if isinstance(places, (list, tuple)):
            if len(places) != 1:
                raise ValueError(
                    f"DataLoader takes one place, got {len(places)}")
            places = places[0]
        self.places = resolve_device(places)
        self.dataset = dataset
        self._custom_collate = collate_fn is not None
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.use_buffer_reader = use_buffer_reader
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no length")
        return len(self.batch_sampler)

    def _produce(self):
        """Host batches: CPU tensors (or whatever a custom collate_fn
        returns)."""
        if self._iterable_mode:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if self.batch_size and len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
            return
        if self.num_workers > 0:
            # default collation: the workers collate numpy and the parent
            # wraps it; a custom collate_fn runs in the parent on the raw
            # samples
            raw = self._custom_collate
            producer = _MultiprocessProducer(
                self.dataset, iter(self.batch_sampler), self.num_workers,
                self.worker_init_fn, self.timeout, raw,
                prefetch_factor=self.prefetch_factor)
            for payload in producer:
                yield self.collate_fn(payload) if raw \
                    else _to_tensors(payload)
        else:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        stager = _DeviceStager(self.places)
        if self.use_buffer_reader:
            return _PrefetchIterator(self._produce, stager,
                                     prefetch=self.prefetch_factor)
        return (stager.land(*stager.send(b)) for b in self._produce())


class WorkerInfo:
    """Identifies the current DataLoader worker process."""

    def __init__(self, id, num_workers, dataset, seed=0):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_worker_info = None


def get_worker_info():
    """Inside a DataLoader worker: its WorkerInfo; in the main process:
    None."""
    return _worker_info
