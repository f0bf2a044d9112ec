"""The CPU's explicit gloo bring-up, PyTorch port.

Counterpart of `paddle_tpu/distributed/parallel_with_gloo.py`
(`gloo_init_parallel_env` / `gloo_barrier` / `gloo_release`): a gloo
process group of its own, on the CPU, over a store that rank 0 hosts at
`server_endpoint`, apart from the world `init_parallel_env` makes (a
parameter-server job's control plane has no NCCL). Every rank checks in
before `gloo_init_parallel_env` returns; `gloo_barrier` is the group's
barrier.
"""
from __future__ import annotations

import torch.distributed as dist

from .env import DEFAULT_TIMEOUT, TCPStore, _timedelta

__all__ = ["gloo_init_parallel_env", "gloo_barrier", "gloo_release"]

_gloo = {"store": None, "group": None}


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint,
                           timeout=DEFAULT_TIMEOUT):
    """Bring up the gloo group of `rank_num` ranks (this one `rank_id`)
    over ``host:port`` `server_endpoint`."""
    host, port = server_endpoint.rsplit(":", 1)
    store = TCPStore(host, int(port), is_master=int(rank_id) == 0,
                     world_size=int(rank_num), timeout=timeout)
    group = dist.ProcessGroupGloo(dist.PrefixStore("gloo", store.store),
                                  int(rank_id), int(rank_num),
                                  _timedelta(timeout))
    _gloo.update(store=store, group=group)
    store.barrier("gloo_init")


def gloo_barrier():
    """Block until every rank of the gloo group reaches the barrier."""
    if _gloo["group"] is None:
        raise RuntimeError("call gloo_init_parallel_env first")
    _gloo["group"].barrier().wait()


def gloo_release():
    """Drop the gloo group and its store (a second call does nothing)."""
    _gloo.update(store=None, group=None)
