"""`fleet.util`, PyTorch port: a rank-aware toolbox.

Counterpart of `paddle_tpu/distributed/fleet/base/util_factory.py`:
`all_reduce` / `barrier` / `all_gather` over the workers (the eager
collectives; nothing to do in a world of one rank), `get_file_shard`
(the reference's contiguous blocking, earlier workers taking the
remainder) and `print_on_rank`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["UtilBase"]


class UtilBase:
    def __init__(self):
        self.role_maker = None

    def _set_role_maker(self, role_maker):
        self.role_maker = role_maker

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        """`input` (array-like) reduced over the workers by `mode` (sum,
        max or min), as a numpy array."""
        from ...collective import ReduceOp, all_reduce
        from ...env import get_world_size, world_device
        ops = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX,
               "min": ReduceOp.MIN}
        if mode not in ops:
            raise ValueError(f"unknown all_reduce mode {mode!r}")
        arr = np.asarray(input)
        if get_world_size() <= 1:
            return arr
        t = torch.as_tensor(arr, device=world_device())
        all_reduce(t, op=ops[mode])
        return t.cpu().numpy()

    def barrier(self, comm_world="worker"):
        from ...collective import barrier
        from ...env import get_world_size
        if get_world_size() > 1:
            barrier()

    def all_gather(self, input, comm_world="worker"):
        """Every worker's picklable `input`, by rank."""
        from ...collective import all_gather_object
        from ...env import get_world_size
        if get_world_size() <= 1:
            return [input]
        out = []
        all_gather_object(out, input)
        return out

    def get_file_shard(self, files):
        """This worker's contiguous share of `files`; earlier workers take
        the remainder."""
        if not isinstance(files, list):
            raise TypeError("files should be a list of file names")
        rm = self.role_maker
        trainer_id = rm._worker_index() if rm else 0
        trainers = rm._worker_num() if rm else 1
        blocks = len(files) // trainers
        remainder = len(files) % trainers
        begin = trainer_id * blocks + min(trainer_id, remainder)
        end = begin + blocks + (1 if trainer_id < remainder else 0)
        return files[begin:end]

    def print_on_rank(self, message, rank_id):
        rm = self.role_maker
        me = rm._worker_index() if rm else 0
        if me == rank_id:
            print(message, flush=True)
