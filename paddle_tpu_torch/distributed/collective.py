"""The collective communication API, PyTorch port.

Counterpart of `paddle_tpu/distributed/collective.py`. The reference runs
each eager collective as a jitted `shard_map` over a device mesh
(`ProcessGroupXLA`); the port runs it as the `torch.distributed` call of
the group's process group (`ProcessGroup`, a thin class over it): NCCL on
the card, gloo on the CPU (`env.init_parallel_env`). Ranks are global
ranks, as the reference's ``src`` / ``dst`` are.

Semantics are the reference's eager API:

- results land in place: `all_reduce`, `broadcast`, `scatter`,
  `reduce_scatter` (into ``tensor``), `alltoall_single` (into
  ``out_tensor``) write the tensor given; `all_gather` and `alltoall` fill
  the list given (cleared first);
- `reduce` leaves the result on every rank, as the reference's (which is
  `all_reduce`); ``ReduceOp.AVG`` is the sum divided by the group's size;
- `send` posts a copy of the tensor and returns (its `Task` waits), so a
  ring where every rank sends before it receives does not deadlock;
  `batch_isend_irecv` posts every send of the batch before any receive;
- a group of one rank gives the reference's single-process answers: with
  no process group (before `init_parallel_env`) each op is local;
  `send` to oneself fills a mailbox that `recv` empties, and
  `reduce_scatter` of a list longer than the group sums it;
- ``sync_op=False`` returns a `Task` whose `wait()` completes the op (and
  fills the lists); with ``sync_op=True`` the op is complete on return,
  as far as the stream order is concerned (on the card the caller's stream
  waits for NCCL's, the host does not).

A group of more than one rank with no process group (made before
`init_parallel_env`, as the topology's groups may be) raises on use.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import env

__all__ = ["ReduceOp", "Group", "Task", "ProcessGroup", "new_group",
           "get_group", "all_reduce", "all_gather", "all_gather_object",
           "reduce", "broadcast", "scatter", "alltoall", "alltoall_single",
           "reduce_scatter", "send", "recv", "isend", "irecv", "barrier",
           "wait", "destroy_process_group", "get_backend", "partial_send",
           "partial_recv", "P2POp", "batch_isend_irecv"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


# AVG is a SUM, then a division by the group's size
_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.SUM}


def _torch_op(op):
    if op not in _TORCH_OP:
        raise ValueError(f"unknown ReduceOp {op!r}")
    return _TORCH_OP[op]


class Task:
    """The handle of a collective (the reference's `ProcessGroup::Task`):
    `wait()` completes it and runs what fills its outputs, once."""

    def __init__(self, works=(), finish=None):
        self._works = [w for w in works if w is not None]
        self._finish = finish

    def wait(self, timeout=None):
        for w in self._works:
            w.wait()
        self._works = []
        if self._finish is not None:
            finish, self._finish = self._finish, None
            finish()
        return True

    def is_completed(self):
        return all(w.is_completed() for w in self._works)

    def synchronize(self):
        self.wait()


def _task(work, finish, sync_op):
    task = Task([work], finish)
    if sync_op:
        task.wait()
    return task


class ProcessGroup:
    """A `torch.distributed` process group (the reference's
    `ProcessGroupXLA`): its handle, its size and its backend."""

    def __init__(self, handle, size):
        self.handle = handle
        self.size = size

    @property
    def backend(self):
        return dist.get_backend(self.handle)


class Group:
    """The reference's `Group`: this rank's index in it (-1 for a rank
    outside it), its size, its id, its global ranks and its process
    group (None for a one-rank group before `init_parallel_env`)."""

    def __init__(self, rank, nranks, id=0, ranks=None, pg=None):
        self.rank = rank
        self.nranks = nranks
        self.id = id
        self.ranks = ranks if ranks is not None else list(range(nranks))
        self.pg = pg

    @property
    def world_size(self):
        return self.nranks

    @property
    def process_group(self):
        return self.pg

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self):
        return self.rank >= 0

    def __repr__(self):
        return f"Group(rank={self.rank}, nranks={self.nranks}, id={self.id})"


# the process's groups by id, the next id, the one-rank mailbox of
# send / recv to oneself, and the sends still in flight
_state = {"groups": {}, "next_gid": 1, "mailbox": {}, "sends": []}


def _default_group():
    group = _state["groups"].get(0)
    if group is None or (group.pg is None) == dist.is_initialized():
        world = env.get_world_size()
        pg = ProcessGroup(dist.group.WORLD, world) \
            if dist.is_initialized() else None
        group = Group(env.get_rank(), world, id=0,
                      ranks=list(range(world)), pg=pg)
        _state["groups"][0] = group
    return group


def _group_or_default(group):
    return group if group is not None else _default_group()


def new_group(ranks=None, backend=None, timeout=None):
    """A group of the global `ranks` (all when None), in increasing order.
    Every rank of the world must call it, in the same order, members or
    not, as `torch.distributed.new_group` requires. Before
    `init_parallel_env` it makes a group with no process group."""
    world = env.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if ranks != sorted(set(ranks)):
        raise ValueError(f"new_group takes distinct ranks in increasing "
                         f"order, got {ranks}")
    gid = _state["next_gid"]
    _state["next_gid"] += 1
    pg = None
    if dist.is_initialized():
        if ranks[-1] >= world:
            raise ValueError(f"new_group: rank {ranks[-1]} is outside the "
                             f"world of {world}")
        handle = dist.new_group(ranks, backend=backend,
                                timeout=env._timedelta(timeout))
        if handle is not dist.GroupMember.NON_GROUP_MEMBER:
            pg = ProcessGroup(handle, len(ranks))
    me = env.get_rank()
    group = Group(ranks.index(me) if me in ranks else -1, len(ranks),
                  id=gid, ranks=ranks, pg=pg)
    _state["groups"][gid] = group
    return group


def get_group(gid=0):
    if gid == 0:
        return _default_group()
    return _state["groups"].get(gid)


def get_backend(group=None):
    """``"nccl"`` or ``"gloo"``; None for a group with no process
    group."""
    group = _group_or_default(group)
    return group.pg.backend if group.pg is not None else None


def destroy_process_group(group=None):
    """Leave the world (``group=None``: every group, then the default
    one), or drop one group."""
    if group is None:
        _drain_sends()
        if dist.is_initialized():
            dist.destroy_process_group()
        env._forget()
        _state.update(groups={}, next_gid=1, mailbox={})
        return
    _state["groups"].pop(group.id, None)
    if group.pg is not None and group.id != 0:
        dist.destroy_process_group(group.pg.handle)


def _route(group):
    """The group's process group, or None where the op is local: a
    one-rank group with none, or a rank outside the group. Raises for a
    larger group with none."""
    if not group.is_member():
        return None
    if group.pg is None and group.nranks > 1:
        raise RuntimeError(f"{group} has {group.nranks} ranks and no process "
                           f"group: call init_parallel_env first")
    return group.pg


def _global(group, rank, what):
    """Global rank `rank` checked to be a member of `group`."""
    if rank not in group.ranks:
        raise ValueError(f"{what} rank {rank} is not a member of group "
                         f"{group.ranks}")
    return rank


def _divide(tensor, n):
    def finish():
        tensor.div_(n)
    return finish


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """`tensor` reduced over the group, in place."""
    group = _group_or_default(group)
    pg = _route(group)
    if pg is None:
        return Task()
    work = dist.all_reduce(tensor, op=_torch_op(op), group=pg.handle,
                           async_op=not sync_op)
    return _task(work, _divide(tensor, pg.size) if op == ReduceOp.AVG
                 else None, sync_op)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reference's `reduce`: `all_reduce` (every rank gets the
    result)."""
    return all_reduce(tensor, op, group, sync_op)


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Every rank's `tensor`, by group rank, into `tensor_list` (a list,
    cleared first; or a tensor, which gets their concatenation along its
    first dimension)."""
    group = _group_or_default(group)
    pg = _route(group)
    n = pg.size if pg is not None else 1
    outs = [torch.empty_like(tensor) for _ in range(n)]
    if pg is None:
        outs[0].copy_(tensor)
        work = None
    else:
        work = dist.all_gather(outs, tensor.contiguous(), group=pg.handle,
                               async_op=not sync_op)

    def finish():
        if isinstance(tensor_list, torch.Tensor):
            tensor_list.copy_(torch.cat(outs).view_as(tensor_list))
        else:
            tensor_list.clear()
            tensor_list.extend(outs)
    return _task(work, finish, sync_op)


def all_gather_object(object_list, obj, group=None):
    """Every rank's picklable `obj`, by group rank, into `object_list`
    (cleared first)."""
    group = _group_or_default(group)
    pg = _route(group)
    if pg is None:
        out = [obj] * group.nranks
    else:
        out = [None] * pg.size
        dist.all_gather_object(out, obj, group=pg.handle)
    object_list.clear()
    object_list.extend(out)


def broadcast(tensor, src, group=None, sync_op=True):
    """Global rank `src`'s `tensor` into every rank's, in place; a `src`
    outside the group means its first rank, as in the reference."""
    group = _group_or_default(group)
    pg = _route(group)
    if pg is None:
        return Task()
    src = src if src in group.ranks else group.ranks[0]
    work = dist.broadcast(tensor, src=src, group=pg.handle,
                          async_op=not sync_op)
    return _task(work, None, sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank `src`'s ``tensor_list[i]`` into group rank i's `tensor`."""
    group = _group_or_default(group)
    pg = _route(group)
    if pg is None:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return Task()
    src = _global(group, src, "scatter src")
    parts = [t.contiguous() for t in tensor_list] \
        if env.get_rank() == src else None
    work = dist.scatter(tensor, parts, src=src, group=pg.handle,
                        async_op=not sync_op)
    return _task(work, None, sync_op)


def alltoall(in_tensor_list, out_tensor_list, group=None, sync_op=True):
    """``in_tensor_list[j]`` to group rank j; `out_tensor_list` (cleared
    first) gets, at i, what group rank i sent this one."""
    group = _group_or_default(group)
    pg = _route(group)
    if pg is None:
        out_tensor_list.clear()
        out_tensor_list.extend(in_tensor_list)
        return Task()
    outs = [torch.empty_like(t) for t in in_tensor_list]
    work = dist.all_to_all(outs, [t.contiguous() for t in in_tensor_list],
                           group=pg.handle, async_op=not sync_op)

    def finish():
        out_tensor_list.clear()
        out_tensor_list.extend(outs)
    return _task(work, finish, sync_op)


def alltoall_single(in_tensor, out_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """`alltoall` over the first dimension of one tensor each way (equal
    chunks, or the split sizes given), into `out_tensor`."""
    group = _group_or_default(group)
    pg = _route(group)
    if pg is None:
        out_tensor.copy_(in_tensor)
        return Task()
    work = dist.all_to_all_single(out_tensor, in_tensor.contiguous(),
                                  out_split_sizes, in_split_sizes,
                                  group=pg.handle, async_op=not sync_op)
    return _task(work, None, sync_op)


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Group rank i's `tensor` gets ``tensor_list[i]`` reduced over the
    group. In a one-rank group a longer list is summed, as in the
    reference."""
    group = _group_or_default(group)
    pg = _route(group)
    if group.nranks == 1 and (pg is None or len(tensor_list) != 1):
        if group.is_member():
            tensor.copy_(torch.stack(list(tensor_list)).sum(0))
        return Task()
    if pg is None:
        return Task()
    work = dist.reduce_scatter(tensor, [t.contiguous() for t in tensor_list],
                               op=_torch_op(op), group=pg.handle,
                               async_op=not sync_op)
    return _task(work, _divide(tensor, pg.size) if op == ReduceOp.AVG
                 else None, sync_op)


def _drain_sends():
    """Wait for the sends still in flight (once each: a gloo send waited
    twice waits for a second transfer)."""
    sends, _state["sends"] = _state["sends"], []
    for work in sends:
        if not work.is_completed():
            work.wait()


def _post_send(tensor, dst, group):
    pg = _route(group)
    if pg is None or group.nranks == 1:
        _state["mailbox"].setdefault(group.id, {})[dst] = tensor.clone()
        return Task()
    _state["sends"] = [w for w in _state["sends"] if not w.is_completed()]
    work = dist.isend(tensor.detach().clone().contiguous(),
                      dst=_global(group, dst, "send dst"), group=pg.handle)
    _state["sends"].append(work)
    return Task([work])


def send(tensor, dst=0, group=None, sync_op=True):
    """Post a copy of `tensor` to global rank `dst` and return; the
    returned `Task` waits for the transfer (module docstring)."""
    return _post_send(tensor, dst, _group_or_default(group))


def _recv(tensor, src, group, sync_op):
    pg = _route(group)
    if pg is None or group.nranks == 1:
        box = _state["mailbox"].get(group.id, {})
        me = env.get_rank()
        if me in box:
            tensor.copy_(box.pop(me))
        return Task()
    buf = tensor if tensor.is_contiguous() else torch.empty_like(
        tensor, memory_format=torch.contiguous_format)
    work = dist.irecv(buf, src=_global(group, src, "recv src"),
                      group=pg.handle)
    finish = None if buf is tensor else (lambda: tensor.copy_(buf))
    return _task(work, finish, sync_op)


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive global rank `src`'s next send into `tensor`."""
    return _recv(tensor, src, _group_or_default(group), sync_op)


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


def _partial_bounds(tensor, nranks, rank_id):
    numel = tensor.numel()
    if numel % nranks:
        raise ValueError(f"partial send/recv needs numel ({numel}) divisible "
                         f"by nranks ({nranks})")
    per = numel // nranks
    return per * rank_id, per * (rank_id + 1)


def partial_send(tensor, dst=0, group=None, nranks=1, rank_id=0):
    """Send the `rank_id`-th of `nranks` equal flat slices of `tensor`."""
    lo, hi = _partial_bounds(tensor, nranks, rank_id)
    return send(tensor.reshape(-1)[lo:hi], dst=dst, group=group)


def partial_recv(tensor, src=0, group=None, nranks=1, rank_id=0):
    """Receive into the `rank_id`-th of `nranks` equal flat slices of
    `tensor`; the rest of it stays as it was."""
    lo, hi = _partial_bounds(tensor, nranks, rank_id)
    buf = tensor.new_zeros(hi - lo)
    recv(buf, src=src, group=group)
    tensor.view(-1)[lo:hi].copy_(buf)
    return Task()


class P2POp:
    """One operation of a batched p2p round: `isend` or `irecv` (or
    `send` / `recv`) of `tensor` with global rank `peer`."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv, send, recv):
            raise ValueError("P2POp op must be paddle.distributed.isend or "
                             "irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Post every send of the list, then every receive, whatever their
    order in it; returns their `Task`s in the list's order."""
    tasks = [None] * len(p2p_op_list)
    for i, op in enumerate(p2p_op_list):
        if op.op in (isend, send):
            tasks[i] = send(op.tensor, dst=op.peer, group=op.group)
    for i, op in enumerate(p2p_op_list):
        if tasks[i] is None:
            tasks[i] = _recv(op.tensor, op.peer,
                             _group_or_default(op.group), sync_op=False)
    return tasks


def barrier(group=None):
    """Block until every rank of the group reaches it (its sends in flight
    delivered first)."""
    group = _group_or_default(group)
    pg = _route(group)
    if pg is None:
        return None
    _drain_sends()
    dist.barrier(group=pg.handle)
    return None


def wait(tensor, group=None, use_calc_stream=True):
    """Block the host until the work queued on `tensor`'s device is
    done."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
