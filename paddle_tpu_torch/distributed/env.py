"""Distributed environment bring-up, PyTorch port.

Counterpart of `paddle_tpu/distributed/env.py`. The reference rendezvouses
its ranks through a TCPStore and then brings up JAX's multi-process
runtime; the port rendezvouses through a `torch.distributed.TCPStore`
(rank 0 hosts it) and brings up one `torch.distributed` process group of
the whole world over it. The launcher's environment is the reference's:
``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` / ``PADDLE_MASTER``
(``host:port``), else ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` (and
``MASTER_PORT``). A world of one rank needs none of them and no port: its
store lives in the process.

The device rule of every entry point of the port: ``device=None`` means
``cuda``, the NCCL backend and one card a rank (``LOCAL_RANK``, else the
rank), and raises where there is no card; ``device="cpu"`` means gloo.
Nothing switches to gloo, or to the CPU, when NCCL fails. Every
rendezvous and process group takes a finite `timeout` (seconds), so a
lost rank fails the others instead of hanging them.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "is_initialized", "get_store", "TCPStore", "DEFAULT_TIMEOUT"]

# seconds a rendezvous, a store wait or a collective may take
DEFAULT_TIMEOUT = 60.0

# the world this process joined: its store and its device
_world = {"store": None, "device": None}


def _env_int(*names, default=0):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return int(v)
    return default


def _timedelta(seconds):
    seconds = float(DEFAULT_TIMEOUT if seconds is None else seconds)
    if not 0 < seconds < float("inf"):
        raise ValueError(f"timeout must be a finite number of seconds > 0, "
                         f"got {seconds}")
    return datetime.timedelta(seconds=seconds)


class TCPStore:
    """A key-value store of the ranks (the reference's `core.TCPStore`
    API: set / get / add / wait / delete_key / barrier) over a
    `torch.distributed` store. ``TCPStore(host, port, is_master,
    world_size, timeout)`` connects to one at ``host:port`` (the master
    also hosts it); `wrap` takes a store that exists."""

    def __init__(self, host_name="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=DEFAULT_TIMEOUT):
        self._init(dist.TCPStore(host_name, int(port), int(world_size),
                                 bool(is_master), timeout=_timedelta(timeout),
                                 wait_for_workers=False),
                   world_size, timeout)

    @classmethod
    def wrap(cls, store, world_size, timeout=DEFAULT_TIMEOUT):
        self = cls.__new__(cls)
        self._init(store, world_size, timeout)
        return self

    def _init(self, store, world_size, timeout):
        self.store = store
        self._world_size = int(world_size)
        self._timeout = _timedelta(timeout)
        self._barrier_round = 0

    def set(self, key, value):
        self.store.set(key, value)

    def get(self, key, wait=True):
        """The value of `key` as bytes, after waiting for it (KeyError
        where ``wait=False`` and it is not set)."""
        if not wait and not self.store.check([key]):
            raise KeyError(key)
        return self.store.get(key)

    def add(self, key, value=1):
        return int(self.store.add(key, int(value)))

    def wait(self, keys, timeout=None):
        keys = [keys] if isinstance(keys, str) else list(keys)
        self.store.wait(keys, self._timeout if timeout is None
                        else _timedelta(timeout))

    def delete_key(self, key):
        return bool(self.store.delete_key(key))

    def barrier(self, tag=""):
        """Block until all world_size participants reach the same barrier
        (the n-th call of each, by `tag`)."""
        self._barrier_round += 1
        key = f"__barrier/{tag}/{self._barrier_round}"
        if self.add(key, 1) >= self._world_size:
            self.set(key + "/done", b"1")
        self.wait([key + "/done"])


def _cuda_for_rank(rank):
    """This rank's card: ``LOCAL_RANK``, else the rank itself."""
    local = _env_int("LOCAL_RANK", default=rank)
    count = torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(f"rank {rank} wants card {local} (LOCAL_RANK or "
                           f"the rank), and this host has {count}")
    return torch.device("cuda", local)


def init_parallel_env(device=None, timeout=DEFAULT_TIMEOUT):
    """Join the world the launcher's environment describes (one rank when
    it describes none) and return `ParallelEnv`. ``device=None`` means
    ``cuda`` and NCCL (raising where there is no card), ``"cpu"`` gloo;
    see the module docstring. A second call returns at once."""
    if dist.is_initialized():
        return ParallelEnv()
    nranks = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    rank = _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
    device = resolve_device(device)
    if device.type == "cuda":
        backend = "nccl"
        device = _cuda_for_rank(rank)
        torch.cuda.set_device(device)
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_parallel_env takes a cuda or cpu device, "
                         f"got {device}")
    td = _timedelta(timeout)
    if nranks > 1:
        master = os.environ.get("PADDLE_MASTER") or \
            os.environ.get("MASTER_ADDR")
        if not master:
            raise RuntimeError(
                f"a world of {nranks} ranks needs PADDLE_MASTER (host:port) "
                f"or MASTER_ADDR and MASTER_PORT")
        host, _, port = master.partition(":")
        port = int(port or os.environ.get("MASTER_PORT", "8476"))
        store = dist.TCPStore(host, port, nranks, rank == 0, timeout=td)
    else:
        store = dist.HashStore()
    # NCCL's communicator made now, on this rank's card
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=nranks, timeout=td, **kwargs)
    _world.update(store=TCPStore.wrap(store, nranks, timeout),
                  device=device)
    _world["store"].barrier("init_parallel_env")
    return ParallelEnv()


def _forget():
    """Drop the world's store and device (`destroy_process_group`)."""
    _world.update(store=None, device=None)


def get_store():
    """The world's rendezvous store (`TCPStore`), None before
    `init_parallel_env`."""
    return _world["store"]


def is_initialized():
    return dist.is_initialized()


def world_device():
    """The device this rank's collectives run on (None before
    `init_parallel_env`)."""
    return _world["device"]


def get_rank(group=None):
    if group is not None:
        return group.rank
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    return dist.get_world_size() if dist.is_initialized() else 1


class ParallelEnv:
    """This rank's place in the world (the reference's `ParallelEnv`)."""

    @property
    def rank(self):
        return get_rank()

    @property
    def local_rank(self):
        return _env_int("LOCAL_RANK", default=get_rank())

    @property
    def world_size(self):
        return get_world_size()

    nranks = world_size

    @property
    def device_id(self):
        device = _world["device"]
        return (device.index or 0) if device is not None else 0

    @property
    def current_endpoint(self):
        eps = self.trainer_endpoints
        r = self.rank
        return eps[r] if r < len(eps) else ""

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []
