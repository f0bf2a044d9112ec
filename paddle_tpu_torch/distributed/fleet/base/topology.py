"""Hybrid topology, PyTorch port.

Counterpart of `paddle_tpu/distributed/fleet/base/topology.py`:
`ParallelMode`, `CommunicateTopology` (the N-D cartesian rank coordinates
over the axes ``data, pipe, sharding, sep, model``, whose arithmetic this
module copies) and `HybridCommunicateGroup` (one group per slice of each
axis). The reference also lays the degrees out as a JAX device mesh; the
port's groups are `torch.distributed` groups (`collective.new_group`),
made by every rank for every slice in the same order, as
`torch.distributed.new_group` requires. In a world that
`init_parallel_env` has brought up, the topology must cover it exactly;
before, the groups carry their ranks and no process group. This slice
trains over the data-parallel group; the others are made and not used
yet (pipeline, tensor and sharding parallelism are ROADMAP item 7(b)).
"""
from __future__ import annotations

import itertools
from functools import reduce

from ...collective import new_group
from ...env import get_rank, get_world_size, is_initialized

__all__ = ["ParallelMode", "CommunicateTopology", "HybridCommunicateGroup"]


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "sep",
                                           "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(itertools.product(
            *[range(d) for d in self._dims]))
        self._world_size = reduce(lambda x, y: x * y, self._dims, 1)
        self._rank2coord = dict(
            zip(range(len(self.coordinate)), self.coordinate))
        self._coord2rank = {c: r for r, c in self._rank2coord.items()}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **args):
        coord = tuple(args[name] for name in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return sorted(r for r, c in self._rank2coord.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name):
        """Every rank group along `axis_name`: one list for each slice of
        the other axes."""
        axis = self._parallel_names.index(axis_name)
        other_dims = [range(d) for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for other in itertools.product(*other_dims):
            ranks = []
            for i in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, i)
                ranks.append(self._coord2rank[tuple(coord)])
            groups.append(ranks)
        return groups

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = list(self.get_coord(global_rank))
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return self._coord2rank[tuple(coord)]


class HybridCommunicateGroup:
    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.global_rank = get_rank()
        if is_initialized() and topology.world_size() != get_world_size():
            raise ValueError(
                f"the topology's degrees {topology._dims} make "
                f"{topology.world_size()} ranks; the world has "
                f"{get_world_size()}")
        self._dp_degree = self._topo.get_dim("data")
        self._mp_degree = self._topo.get_dim("model")
        self._pp_degree = self._topo.get_dim("pipe")
        self._sharding_degree = self._topo.get_dim("sharding")
        self._sep_degree = self._topo.get_dim("sep") \
            if "sep" in self._topo.get_hybrid_group_names() else 1

        self._dp_group = self._build_group("data")
        self._mp_group = self._build_group("model")
        self._pp_group = self._build_group("pipe")
        self._sharding_group = self._build_group("sharding")
        self._sep_group = self._build_group("sep") if self._sep_degree > 1 \
            else None

    def _build_group(self, axis):
        """Every slice's group along `axis` (made on every rank); returns
        this rank's."""
        mine = None
        for ranks in self._topo.get_comm_list(axis):
            group = new_group(ranks)
            if self.global_rank in ranks:
                mine = group
        return mine

    # -- parallel mode --------------------------------------------------------
    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return ParallelMode.PIPELINE_PARALLEL
        if self._sharding_degree > 1:
            return ParallelMode.SHARDING_PARALLEL
        if self._mp_degree > 1:
            return ParallelMode.TENSOR_PARALLEL
        return ParallelMode.DATA_PARALLEL

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    def _coord(self, axis):
        return self._topo.get_coord(self.global_rank)[
            self._topo.get_hybrid_group_names().index(axis)]

    # -- data parallel --------------------------------------------------------
    def get_data_parallel_rank(self):
        return self._coord("data")

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    # -- model parallel -------------------------------------------------------
    def get_model_parallel_rank(self):
        return self._coord("model")

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    # -- pipeline -------------------------------------------------------------
    def get_stage_id(self):
        return self._coord("pipe")

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_group

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    # -- sharding -------------------------------------------------------------
    def get_sharding_parallel_rank(self):
        return self._coord("sharding")

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group.ranks[0]

    # -- sep ------------------------------------------------------------------
    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._sep_group
