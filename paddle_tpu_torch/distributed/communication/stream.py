"""The stream variants of the collectives, PyTorch port.

Counterpart of `paddle_tpu/distributed/communication/stream.py`: each
primitive with the reference's argument order and its `sync_op` /
`use_calc_stream`. `torch.distributed` runs NCCL's collectives on a
stream of its own, which the caller's stream waits for (``sync_op=True``)
or which the returned `Task` waits for (``sync_op=False``);
`use_calc_stream` is taken for the reference's signature and changes
nothing. Each primitive is `distributed.collective`'s.
"""
from __future__ import annotations

from .. import collective as _c

__all__ = ["all_gather", "all_reduce", "alltoall", "alltoall_single",
           "broadcast", "reduce", "reduce_scatter", "recv", "scatter",
           "send"]


def all_reduce(tensor, op=_c.ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_reduce(tensor, op=op, group=group, sync_op=sync_op)


def all_gather(tensor_or_tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_gather(tensor_or_tensor_list, tensor, group=group,
                         sync_op=sync_op)


def alltoall(out_tensor_or_tensor_list, in_tensor_or_tensor_list,
             group=None, sync_op=True, use_calc_stream=False):
    return _c.alltoall(in_tensor_or_tensor_list, out_tensor_or_tensor_list,
                       group=group, sync_op=sync_op)


def alltoall_single(out_tensor, in_tensor, out_split_sizes=None,
                    in_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    return _c.alltoall_single(in_tensor, out_tensor,
                              in_split_sizes=in_split_sizes,
                              out_split_sizes=out_split_sizes,
                              group=group, sync_op=sync_op)


def broadcast(tensor, src, group=None, sync_op=True, use_calc_stream=False):
    return _c.broadcast(tensor, src, group=group, sync_op=sync_op)


def reduce(tensor, dst=0, op=_c.ReduceOp.SUM, group=None, sync_op=True,
           use_calc_stream=False):
    return _c.reduce(tensor, dst, op=op, group=group, sync_op=sync_op)


def reduce_scatter(tensor, tensor_or_tensor_list, op=_c.ReduceOp.SUM,
                   group=None, sync_op=True, use_calc_stream=False):
    return _c.reduce_scatter(tensor, tensor_or_tensor_list, op=op,
                             group=group, sync_op=sync_op)


def scatter(tensor, tensor_or_tensor_list=None, src=0, group=None,
            sync_op=True, use_calc_stream=False):
    return _c.scatter(tensor, tensor_or_tensor_list, src=src, group=group,
                      sync_op=sync_op)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.send(tensor, dst=dst, group=group, sync_op=sync_op)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.recv(tensor, src=src, group=group, sync_op=sync_op)
